"""Optimizer op lowerings (counterpart of ``paddle_tpu/ops/optimizer_ops.py``):
``sgd``, ``momentum``, ``adam``, ``adagrad``, ``decayed_adagrad``,
``adadelta``, ``adamax``, ``rmsprop``, ``ftrl``, ``proximal_gd``,
``proximal_adagrad`` and ``average_accumulates`` (``ModelAverage``).

Each op returns its updated slots (ParamOut, VelocityOut, Moment1Out, ...)
as new tensors; the executor writes persistable outputs back into the scope.
"""

import torch

from .registry import register_lowering


def _scalar(ctx, op, slot):
    return torch.reshape(ctx.get(op, slot), ())


@register_lowering('sgd')
def _sgd(ctx, op):
    p = ctx.get(op, 'Param')
    g = ctx.get(op, 'Grad')
    ctx.set(op, 'ParamOut', p - _scalar(ctx, op, 'LearningRate') * g)


@register_lowering('momentum')
def _momentum(ctx, op):
    """v = mu * v + g; p -= lr * v, or p -= lr * (g + mu * v) with Nesterov
    (the reference's form: torch.optim.SGD's momentum dampens g)."""
    p = ctx.get(op, 'Param')
    g = ctx.get(op, 'Grad')
    v = ctx.get(op, 'Velocity')
    lr = _scalar(ctx, op, 'LearningRate')
    mu = op.attrs['mu']
    v_out = mu * v + g
    if op.attrs.get('use_nesterov', False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    ctx.set(op, 'ParamOut', p_out)
    ctx.set(op, 'VelocityOut', v_out)


@register_lowering('adam')
def _adam(ctx, op):
    p = ctx.get(op, 'Param')
    g = ctx.get(op, 'Grad')
    m1 = ctx.get(op, 'Moment1')
    m2 = ctx.get(op, 'Moment2')
    b1p = _scalar(ctx, op, 'Beta1Pow')
    b2p = _scalar(ctx, op, 'Beta2Pow')
    lr = _scalar(ctx, op, 'LearningRate')
    b1 = op.attrs.get('beta1', 0.9)
    b2 = op.attrs.get('beta2', 0.999)
    eps = op.attrs.get('epsilon', 1e-8)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    ctx.set(op, 'ParamOut', p_out)
    ctx.set(op, 'Moment1Out', m1_out)
    ctx.set(op, 'Moment2Out', m2_out)


@register_lowering('adagrad')
def _adagrad(ctx, op):
    p = ctx.get(op, 'Param')
    g = ctx.get(op, 'Grad')
    mom_out = ctx.get(op, 'Moment') + torch.square(g)
    eps = op.attrs.get('epsilon', 1e-6)
    ctx.set(op, 'ParamOut', p - _scalar(ctx, op, 'LearningRate') * g /
            (torch.sqrt(mom_out) + eps))
    ctx.set(op, 'MomentOut', mom_out)


@register_lowering('decayed_adagrad')
def _decayed_adagrad(ctx, op):
    p = ctx.get(op, 'Param')
    g = ctx.get(op, 'Grad')
    decay = op.attrs.get('decay', 0.95)
    eps = op.attrs.get('epsilon', 1e-6)
    mom_out = decay * ctx.get(op, 'Moment') + (1 - decay) * torch.square(g)
    ctx.set(op, 'ParamOut', p - _scalar(ctx, op, 'LearningRate') * g /
            (torch.sqrt(mom_out) + eps))
    ctx.set(op, 'MomentOut', mom_out)


@register_lowering('adadelta')
def _adadelta(ctx, op):
    """No learning rate: the step is sqrt(avg update^2 / avg grad^2) g."""
    p = ctx.get(op, 'Param')
    g = ctx.get(op, 'Grad')
    asu = ctx.get(op, 'AvgSquaredUpdate')
    rho = op.attrs.get('rho', 0.95)
    eps = op.attrs.get('epsilon', 1e-6)
    asg_out = rho * ctx.get(op, 'AvgSquaredGrad') + (1 - rho) * \
        torch.square(g)
    update = -torch.sqrt((asu + eps) / (asg_out + eps)) * g
    ctx.set(op, 'ParamOut', p + update)
    ctx.set(op, 'AvgSquaredGradOut', asg_out)
    ctx.set(op, 'AvgSquaredUpdateOut',
            rho * asu + (1 - rho) * torch.square(update))


@register_lowering('adamax')
def _adamax(ctx, op):
    p = ctx.get(op, 'Param')
    g = ctx.get(op, 'Grad')
    b1 = op.attrs.get('beta1', 0.9)
    b2 = op.attrs.get('beta2', 0.999)
    eps = op.attrs.get('epsilon', 1e-8)
    m_out = b1 * ctx.get(op, 'Moment') + (1 - b1) * g
    inf_out = torch.maximum(b2 * ctx.get(op, 'InfNorm'), torch.abs(g) + eps)
    lr_t = _scalar(ctx, op, 'LearningRate') / (1 - _scalar(ctx, op,
                                                           'Beta1Pow'))
    ctx.set(op, 'ParamOut', p - lr_t * m_out / inf_out)
    ctx.set(op, 'MomentOut', m_out)
    ctx.set(op, 'InfNormOut', inf_out)


@register_lowering('rmsprop')
def _rmsprop(ctx, op):
    p = ctx.get(op, 'Param')
    g = ctx.get(op, 'Grad')
    eps = op.attrs.get('epsilon', 1e-10)
    decay = op.attrs.get('decay', 0.9)
    momentum = op.attrs.get('momentum', 0.0)
    ms_out = decay * ctx.get(op, 'MeanSquare') + (1 - decay) * \
        torch.square(g)
    mom_out = momentum * ctx.get(op, 'Moment') + \
        _scalar(ctx, op, 'LearningRate') * g / torch.sqrt(ms_out + eps)
    ctx.set(op, 'ParamOut', p - mom_out)
    ctx.set(op, 'MomentOut', mom_out)
    ctx.set(op, 'MeanSquareOut', ms_out)


def ftrl_update(p, g, sq, lin, lr, l1, l2, lr_power):
    """FTRL-proximal on (param, squared and linear accumulators) rows:
    (param, squared, linear) after the step.  Shared with the sparse
    form."""
    sq_new = sq + torch.square(g)
    pow_new = torch.pow(sq_new, -lr_power)
    pow_old = torch.pow(sq, -lr_power)
    lin_new = lin + g - (pow_new - pow_old) / lr * p
    x = l1 * torch.sign(lin_new) - lin_new
    y = pow_new / lr + 2 * l2
    p_new = torch.where(torch.abs(lin_new) > l1, x / y,
                        torch.zeros_like(p))
    return p_new, sq_new, lin_new


@register_lowering('ftrl')
def _ftrl(ctx, op):
    p_out, sq_out, lin_out = ftrl_update(
        ctx.get(op, 'Param'), ctx.get(op, 'Grad'),
        ctx.get(op, 'SquaredAccumulator'), ctx.get(op, 'LinearAccumulator'),
        _scalar(ctx, op, 'LearningRate'), op.attrs.get('l1', 0.0),
        op.attrs.get('l2', 0.0), op.attrs.get('lr_power', -0.5))
    ctx.set(op, 'ParamOut', p_out)
    ctx.set(op, 'SquaredAccumOut', sq_out)
    ctx.set(op, 'LinearAccumOut', lin_out)


def _prox(prox, lr, l1, l2):
    """sign(v) max(|v| - lr l1, 0) / (1 + lr l2): the L1/L2 proximal
    step."""
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                           min=0.0) / (1.0 + lr * l2))


@register_lowering('proximal_gd')
def _proximal_gd(ctx, op):
    lr = _scalar(ctx, op, 'LearningRate')
    prox = ctx.get(op, 'Param') - lr * ctx.get(op, 'Grad')
    ctx.set(op, 'ParamOut', _prox(prox, lr, op.attrs.get('l1', 0.0),
                                  op.attrs.get('l2', 0.0)))


@register_lowering('proximal_adagrad')
def _proximal_adagrad(ctx, op):
    """Adagrad's moment, then the proximal step at each element's
    effective rate.  An element whose moment is still 0 (no gradient ever)
    keeps its value, as in the JAX package (the reference kernel gives NaN
    there)."""
    p = ctx.get(op, 'Param')
    g = ctx.get(op, 'Grad')
    m_out = ctx.get(op, 'Moment') + g * g
    eff_lr = _scalar(ctx, op, 'LearningRate') / (torch.sqrt(m_out) + 1e-10)
    out = _prox(p - eff_lr * g, eff_lr, op.attrs.get('l1', 0.0),
                op.attrs.get('l2', 0.0))
    ctx.set(op, 'ParamOut', torch.where(m_out > 0, out, p))
    ctx.set(op, 'MomentOut', m_out)


# kMaxNumAccumulates of the reference's average_accumulates op
_MAX_NUM_ACCUMULATES = 16384


@register_lowering('average_accumulates')
def _average_accumulates(ctx, op):
    """ModelAverage's sums of the parameter: sum_1 takes every step and
    rolls into sum_2 every kMaxNumAccumulates updates; when the average
    window closes, sum_1 + sum_2 becomes sum_3 and the counts restart."""
    p = ctx.get(op, 'param')
    sum_1 = ctx.get(op, 'in_sum_1')
    sum_2 = ctx.get(op, 'in_sum_2')
    sum_3 = ctx.get(op, 'in_sum_3')
    num_acc = _scalar(ctx, op, 'in_num_accumulates') + 1
    old_num_acc = _scalar(ctx, op, 'in_old_num_accumulates')
    num_upd = _scalar(ctx, op, 'in_num_updates') + 1
    avg_window = op.attrs.get('average_window', 0.0)
    min_avg = op.attrs.get('min_average_window', 10000)
    max_avg = op.attrs.get('max_average_window', 10000)

    sum_1 = sum_1 + p
    roll2 = (num_upd % _MAX_NUM_ACCUMULATES) == 0
    sum_2 = torch.where(roll2, sum_2 + sum_1, sum_2)
    sum_1 = torch.where(roll2, torch.zeros_like(sum_1), sum_1)
    window = torch.clamp(num_upd.to(torch.float32) * avg_window,
                         max=float(max_avg))
    close = (num_acc >= min_avg) & (num_acc.to(torch.float32) >= window)
    sum_3 = torch.where(close, sum_1 + sum_2, sum_3)
    sum_1 = torch.where(close, torch.zeros_like(sum_1), sum_1)
    sum_2 = torch.where(close, torch.zeros_like(sum_2), sum_2)
    old_num_acc = torch.where(close, num_acc, old_num_acc)
    num_acc = torch.where(close, torch.zeros_like(num_acc), num_acc)

    ctx.set(op, 'out_sum_1', sum_1)
    ctx.set(op, 'out_sum_2', sum_2)
    ctx.set(op, 'out_sum_3', sum_3)
    ctx.set(op, 'out_num_accumulates', torch.reshape(num_acc, (1, )))
    ctx.set(op, 'out_old_num_accumulates', torch.reshape(old_num_acc, (1, )))
    ctx.set(op, 'out_num_updates', torch.reshape(num_upd, (1, )))
