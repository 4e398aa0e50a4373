"""Shape op lowerings and aliases from ``paddle_tpu/ops/misc_ops.py``:
``flatten`` and the ``*2`` forms ``flatten2``, ``squeeze2`` and
``unsqueeze2`` (each also writing ``XShape``, an empty [0, *X.shape]
tensor, as the JAX package does), and ``arg_max`` / ``arg_min``, second
names of ``argmax`` / ``argmin``."""

import math

import torch

from .registry import register_lowering, _LOWERINGS
from . import tensor_ops

# aliases: the same lowering under a second registered name
_LOWERINGS['arg_max'] = _LOWERINGS['argmax']
_LOWERINGS['arg_min'] = _LOWERINGS['argmin']


def _flatten(x, axis):
    """X as [prod(dims before axis), prod(the rest)]."""
    return torch.reshape(x, (math.prod(x.shape[:axis]) if axis else 1, -1))


@register_lowering('flatten')
def _flatten_op(ctx, op):
    ctx.set(op, 'Out', _flatten(ctx.get(op, 'X'), op.attrs.get('axis', 1)))


@register_lowering('flatten2')
def _flatten2(ctx, op):
    x = ctx.get(op, 'X')
    ctx.set(op, 'Out', _flatten(x, op.attrs.get('axis', 1)))
    tensor_ops.write_xshape(ctx, op, x)


@register_lowering('squeeze2')
def _squeeze2(ctx, op):
    x = ctx.get(op, 'X')
    _LOWERINGS['squeeze'](ctx, op)
    tensor_ops.write_xshape(ctx, op, x)


@register_lowering('unsqueeze2')
def _unsqueeze2(ctx, op):
    x = ctx.get(op, 'X')
    _LOWERINGS['unsqueeze'](ctx, op)
    tensor_ops.write_xshape(ctx, op, x)
