"""Learning-rate schedules (counterpart of
``paddle_tpu/fluid/layers/learning_rate_scheduler.py``).

Each schedule appends ops that compute the learning rate from a global step
counter (``autoincreased_step_counter``, advanced once per run), so the
schedule is part of the training block.  On the card the block is captured
with it: each replay advances the counter's state buffer, and the rate
follows it.
"""

import math

from . import control_flow
from . import nn
from . import ops
from . import tensor
from ..layer_helper import LayerHelper

__all__ = [
    'exponential_decay', 'natural_exp_decay', 'inverse_time_decay',
    'polynomial_decay', 'piecewise_decay', 'noam_decay', 'append_LARS',
]


def _decay_step_counter(begin=0):
    global_step = nn.autoincreased_step_counter(
        counter_name='@LR_DECAY_COUNTER@', begin=begin, step=1)
    return tensor.cast(global_step, 'float32')


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 * min(step^-0.5, step * warmup_steps^-1.5), the step
    counted from 1."""
    global_step = _decay_step_counter(1)
    a = ops.pow(global_step, factor=-0.5)
    b = ops.scale(global_step, scale=warmup_steps**-1.5)
    return ops.scale(ops.elementwise_min(a, b), scale=d_model**-0.5)


def _div_res(global_step, decay_steps, staircase):
    div_res = ops.scale(global_step, scale=1.0 / decay_steps)
    return ops.floor(div_res) if staircase else div_res


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """learning_rate * decay_rate ^ (step / decay_steps)."""
    div_res = _div_res(_decay_step_counter(), decay_steps, staircase)
    # rate^x = exp(x ln rate)
    decayed = ops.exp(ops.scale(div_res, scale=math.log(decay_rate)))
    return ops.scale(decayed, scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """learning_rate * exp(-decay_rate * step / decay_steps)."""
    div_res = _div_res(_decay_step_counter(), decay_steps, staircase)
    decayed = ops.exp(ops.scale(div_res, scale=-float(decay_rate)))
    return ops.scale(decayed, scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """learning_rate / (1 + decay_rate * step / decay_steps)."""
    div_res = _div_res(_decay_step_counter(), decay_steps, staircase)
    denom = ops.scale(div_res, scale=float(decay_rate), bias=1.0)
    lr = tensor.fill_constant(shape=[1], dtype='float32',
                              value=float(learning_rate))
    return ops.elementwise_div(lr, denom)


def polynomial_decay(learning_rate,
                     decay_steps,
                     end_learning_rate=0.0001,
                     power=1.0,
                     cycle=False):
    """(learning_rate - end) * (1 - step / decay_steps)^power + end; with
    ``cycle`` decay_steps grows to the next multiple past the step."""
    global_step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(ops.scale(global_step, scale=1.0 / decay_steps))
        # at step 0 the multiple is 1
        tensor.fill_constant(shape=[1], dtype='float32', value=0.0)
        one = tensor.fill_constant(shape=[1], dtype='float32', value=1.0)
        div_res = ops.elementwise_max(div_res, one)
        decay_steps_var = ops.scale(div_res, scale=float(decay_steps))
        ratio = ops.elementwise_div(global_step, decay_steps_var)
    else:
        capped = ops.elementwise_min(
            global_step,
            tensor.fill_constant(shape=[1], dtype='float32',
                                 value=float(decay_steps)))
        ratio = ops.scale(capped, scale=1.0 / decay_steps)
    powed = ops.pow(ops.scale(ratio, scale=-1.0, bias=1.0),
                    factor=float(power))
    return ops.scale(
        powed, scale=float(learning_rate) - float(end_learning_rate),
        bias=0.0) + float(end_learning_rate)


def piecewise_decay(boundaries, values):
    """values[i] for boundaries[i-1] <= step < boundaries[i]: a chain of
    ``where_select`` ops from the last boundary back."""
    if len(values) - len(boundaries) != 1:
        raise ValueError('len(values) must be len(boundaries) + 1')
    global_step = _decay_step_counter()
    lr = tensor.fill_constant(shape=[1], dtype='float32',
                              value=float(values[-1]))
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        boundary = tensor.fill_constant(shape=[1], dtype='float32',
                                        value=float(b))
        cond = control_flow.less_than(global_step, boundary)
        vconst = tensor.fill_constant(shape=[1], dtype='float32',
                                      value=float(v))
        helper = LayerHelper('piecewise_select')
        out = helper.create_variable_for_type_inference('float32')
        helper.append_op(type='where_select',
                         inputs={'Cond': [cond], 'X': [vconst], 'Y': [lr]},
                         outputs={'Out': [out]})
        lr = out
    return lr


def append_LARS(params_grads, learning_rate, weight_decay):
    """LARS: each parameter's learning rate scaled by
    |param| / (|grad| + weight_decay |param|), set as its
    ``optimize_attr['learning_rate']``."""

    def _balanced_weight(param_norm, grad_norm):
        if weight_decay == 1.0:
            return grad_norm + param_norm
        return grad_norm + weight_decay * param_norm

    for param, grad in params_grads:
        param_lr = param.optimize_attr['learning_rate']
        param_norm = ops.sqrt(nn.reduce_sum(input=ops.square(param)))
        grad_norm = ops.sqrt(nn.reduce_sum(input=ops.square(grad)))
        if type(param_lr) == float and param_lr == 1.0:
            decayed_lr = learning_rate * param_norm / _balanced_weight(
                param_norm, grad_norm)
        else:
            decayed_lr = learning_rate * param_lr * param_norm / \
                _balanced_weight(param_norm, grad_norm)
        param.optimize_attr['learning_rate'] = decayed_lr
