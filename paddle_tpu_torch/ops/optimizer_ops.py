"""Optimizer op lowerings (counterpart of ``paddle_tpu/ops/optimizer_ops.py``:
``sgd``, ``momentum`` and ``adam``).

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
