"""Activation op lowerings (counterpart of
``paddle_tpu/ops/activation_ops.py``, every lowering of it): the unary
family, the activations with attrs (at the reference's defaults),
``softmax``, ``prelu`` and ``maxout``.

Each is a plain function of tensors, functional as the generic grad's
``torch.func.vjp`` replay needs.
"""

import torch
import torch.nn.functional as F

from .registry import register_lowering, amp_upcast_f32


def _register_unary(name, fn):
    @register_lowering(name)
    def _lower(ctx, op, fn=fn):
        ctx.set(op, 'Out', fn(ctx.get(op, 'X')))


_register_unary('relu', torch.relu)
_register_unary('sigmoid', torch.sigmoid)
_register_unary('logsigmoid', F.logsigmoid)
_register_unary('tanh', torch.tanh)
_register_unary('tanh_shrink', lambda x: x - torch.tanh(x))
_register_unary('exp', torch.exp)
_register_unary('log', torch.log)
_register_unary('sqrt', torch.sqrt)
_register_unary('square', torch.square)
_register_unary('abs', torch.abs)
_register_unary('ceil', torch.ceil)
_register_unary('floor', torch.floor)
_register_unary('round', torch.round)  # half to even, as jnp.round
_register_unary('reciprocal', torch.reciprocal)
_register_unary('sin', torch.sin)
_register_unary('cos', torch.cos)
_register_unary('softsign', lambda x: x / (1.0 + torch.abs(x)))
# jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20
_register_unary('softplus', lambda x: torch.logaddexp(x, torch.zeros_like(x)))
_register_unary('relu6', lambda x: torch.clamp(x, 0.0, 6.0))


@register_lowering('leaky_relu')
def _leaky_relu(ctx, op):
    x = ctx.get(op, 'X')
    alpha = op.attrs.get('alpha', 0.02)
    ctx.set(op, 'Out', torch.where(x >= 0, x, alpha * x))


@register_lowering('elu')
def _elu(ctx, op):
    x = ctx.get(op, 'X')
    alpha = op.attrs.get('alpha', 1.0)
    ctx.set(op, 'Out', torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0)))


@register_lowering('brelu')
def _brelu(ctx, op):
    x = ctx.get(op, 'X')
    ctx.set(op, 'Out', torch.clamp(x, op.attrs.get('t_min', 0.0),
                                   op.attrs.get('t_max', 24.0)))


@register_lowering('soft_relu')
def _soft_relu(ctx, op):
    x = ctx.get(op, 'X')
    t = op.attrs.get('threshold', 40.0)
    ctx.set(op, 'Out', torch.log1p(torch.exp(torch.clamp(x, -t, t))))


@register_lowering('hard_sigmoid')
def _hard_sigmoid(ctx, op):
    x = ctx.get(op, 'X')
    slope = op.attrs.get('slope', 0.2)
    offset = op.attrs.get('offset', 0.5)
    ctx.set(op, 'Out', torch.clamp(slope * x + offset, 0.0, 1.0))


@register_lowering('thresholded_relu')
def _thresholded_relu(ctx, op):
    x = ctx.get(op, 'X')
    t = op.attrs.get('threshold', 1.0)
    ctx.set(op, 'Out', torch.where(x > t, x, torch.zeros_like(x)))


@register_lowering('hard_shrink')
def _hard_shrink(ctx, op):
    x = ctx.get(op, 'X')
    t = op.attrs.get('threshold', 0.5)
    ctx.set(op, 'Out', torch.where(torch.abs(x) > t, x, torch.zeros_like(x)))


@register_lowering('softshrink')
def _softshrink(ctx, op):
    x = ctx.get(op, 'X')
    lam = op.attrs.get('lambda', 0.5)
    ctx.set(op, 'Out',
            torch.where(x > lam, x - lam,
                        torch.where(x < -lam, x + lam, torch.zeros_like(x))))


@register_lowering('stanh')
def _stanh(ctx, op):
    x = ctx.get(op, 'X')
    a = op.attrs.get('scale_a', 0.67)
    b = op.attrs.get('scale_b', 1.7159)
    ctx.set(op, 'Out', b * torch.tanh(a * x))


@register_lowering('swish')
def _swish(ctx, op):
    x = ctx.get(op, 'X')
    beta = op.attrs.get('beta', 1.0)
    ctx.set(op, 'Out', x * torch.sigmoid(beta * x))


@register_lowering('softmax')
def _softmax(ctx, op):
    # fluid softmax normalizes the trailing axis; exp/sum in f32 for bf16
    x = ctx.get(op, 'X')
    ctx.set(op, 'Out', torch.softmax(amp_upcast_f32(x), dim=-1).to(x.dtype))


@register_lowering('prelu')
def _prelu(ctx, op):
    x = ctx.get(op, 'X')
    alpha = ctx.get(op, 'Alpha')
    mode = op.attrs.get('mode', 'all')
    if mode == 'all':
        a = torch.reshape(alpha, ())
    elif mode == 'channel':
        a = torch.reshape(alpha, (1, -1) + (1, ) * (x.dim() - 2))
    else:  # element
        a = torch.reshape(alpha, (1, ) + tuple(x.shape[1:]))
    ctx.set(op, 'Out', torch.where(x > 0, x, a * x))


@register_lowering('maxout')
def _maxout(ctx, op):
    x = ctx.get(op, 'X')  # NCHW
    groups = op.attrs['groups']
    n, c, h, w = x.shape
    ctx.set(op, 'Out',
            torch.amax(torch.reshape(x, (n, c // groups, groups, h, w)),
                       dim=2))
