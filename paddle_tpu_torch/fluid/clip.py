"""Gradient / error clipping (counterpart of ``paddle_tpu/fluid/clip.py``):
by value (``clip``), by norm (``clip_by_norm``) and by global norm."""

import copy

from . import framework
from . import layers
from .layers import ops as _ops

__all__ = [
    'ErrorClipByValue', 'GradientClipByValue', 'GradientClipByNorm',
    'GradientClipByGlobalNorm', 'append_gradient_clip_ops',
    'error_clip_callback', 'set_gradient_clip',
]


class BaseErrorClipAttr(object):
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError()


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _append_clip_op(self, block, grad_name):
        block.append_op(
            type='clip',
            inputs={'X': [grad_name]},
            outputs={'Out': [grad_name]},
            attrs={'min': self.min,
                   'max': self.max})


def error_clip_callback(block, context):
    op = context['op']
    for grad_n in [n for ns in op.outputs.values() for n in ns if n]:
        base = grad_n.split('@RENAME@')[0]
        if not base.endswith(framework.GRAD_VAR_SUFFIX):
            continue
        fwd_var = block._find_var_recursive(
            base[:-len(framework.GRAD_VAR_SUFFIX)])
        if fwd_var is None:
            continue
        error_clip = getattr(fwd_var, 'error_clip', None)
        if error_clip is not None:
            error_clip._append_clip_op(block, grad_n)


class BaseGradientClipAttr(object):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError()


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _create_operators(self, param, grad):
        new_grad = layers.clip(x=grad, min=self.min, max=self.max)
        return param, new_grad


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _create_operators(self, param, grad):
        new_grad = layers.clip_by_norm(x=grad, max_norm=self.clip_norm)
        return param, new_grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale all grads by clip_norm/max(global_norm, clip_norm)
    (reference clip.py GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm, group_name='default_group'):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + '_clip_value'] = self.clip_norm
            context[self.group_name + '_clip'] = layers.fill_constant(
                shape=[1], dtype='float32', value=self.clip_norm)
        local_norm_var = layers.reduce_sum(
            input=_ops.square(grad))
        context[self.group_name].append(local_norm_var)
        self.context = context

    def _create_operators(self, param, grad):
        group_scale_name = self.group_name + '_scale'
        if group_scale_name not in self.context:
            group_norm_var = layers.sums(input=self.context[self.group_name])
            group_norm_var = _ops.sqrt(x=group_norm_var)
            clip_var = self.context[self.group_name + '_clip']
            group_scale_var = layers.elementwise_div(
                x=clip_var,
                y=layers.elementwise_max(x=clip_var, y=group_norm_var))
            self.context[group_scale_name] = group_scale_var
        new_grad = layers.elementwise_mul(
            x=grad, y=self.context[group_scale_name])
        return param, new_grad


_gradient_clip_attr = None


def set_gradient_clip(clip, param_list=None, program=None):
    global _gradient_clip_attr
    if program is None:
        program = framework.default_main_program()
    if param_list is None:
        param_list = program.all_parameters()
    param_list = [
        program.global_block().var(p) if isinstance(p, str) else p
        for p in param_list
    ]
    for param in param_list:
        param.gradient_clip_attr = copy.deepcopy(clip)
    _gradient_clip_attr = clip


def append_gradient_clip_ops(param_grad):
    context = dict()
    res = []
    for p, g in param_grad:
        clip_attr = getattr(p, 'gradient_clip_attr', None) or \
            NullGradientClipAttr()
        clip_attr._process_context(context=context, param=p, grad=g)
    for p, g in param_grad:
        clip_attr = getattr(p, 'gradient_clip_attr', None) or \
            NullGradientClipAttr()
        res.append(clip_attr._create_operators(param=p, grad=g))
    return res
