"""Tensor creation / manipulation op lowerings (counterpart of
``paddle_tpu/ops/tensor_ops.py``).

Random ops draw from the context's ``torch.Generator`` (the executor seeds
it from ``program.random_seed``), or from a generator of their own when the
op carries a nonzero ``seed`` attr.  Torch and JAX streams differ, so the
same seed gives other numbers than the JAX package.
"""

import numpy as np
import torch

from .registry import (register_lowering, register_grad_lowering,
                       fwd_structure, GRAD_SUFFIX)
from ..fluid import core


def _torch_dtype(attr_dtype):
    if attr_dtype is None:
        return torch.float32
    return core.convert_dtype_to_torch(attr_dtype)


def _generator(ctx, op):
    seed = op.attrs.get('seed', 0)
    if not seed:
        return ctx.generator
    g = torch.Generator(device=ctx.device)
    g.manual_seed(int(seed))
    return g


@register_lowering('fill_constant')
def _fill_constant(ctx, op):
    ctx.set(op, 'Out', torch.full(tuple(op.attrs.get('shape', [1])),
                                  op.attrs.get('value', 0.0),
                                  dtype=_torch_dtype(op.attrs.get('dtype')),
                                  device=ctx.device))


@register_lowering('uniform_random')
def _uniform_random(ctx, op):
    out = torch.empty(tuple(op.attrs.get('shape')), dtype=torch.float32,
                      device=ctx.device)
    out.uniform_(op.attrs.get('min', -1.0), op.attrs.get('max', 1.0),
                 generator=_generator(ctx, op))
    ctx.set(op, 'Out', out.to(_torch_dtype(op.attrs.get('dtype'))))


@register_lowering('gaussian_random')
def _gaussian_random(ctx, op):
    out = torch.empty(tuple(op.attrs.get('shape')), dtype=torch.float32,
                      device=ctx.device)
    out.normal_(op.attrs.get('mean', 0.0), op.attrs.get('std', 1.0),
                generator=_generator(ctx, op))
    ctx.set(op, 'Out', out.to(_torch_dtype(op.attrs.get('dtype'))))


@register_lowering('reshape')
def _reshape(ctx, op):
    x = ctx.get(op, 'X')
    shape_in = ctx.get(op, 'Shape')
    # a Shape input (actual_shape) overrides the attr at run time
    shape = (op.attrs['shape'] if shape_in is None else
             [int(s) for s in shape_in.tolist()])
    # 0 means "copy from input dim i"
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    ctx.set(op, 'Out', torch.reshape(x, tuple(shape)))


@register_lowering('unsqueeze')
def _unsqueeze(ctx, op):
    out = ctx.get(op, 'X')
    for a in sorted(op.attrs['axes']):
        out = torch.unsqueeze(out, a)
    ctx.set(op, 'Out', out)


@register_lowering('assign')
def _assign(ctx, op):
    ctx.set(op, 'Out', ctx.get(op, 'X'))


@register_grad_lowering('assign')
def _assign_grad(ctx, op):
    """Identity pass-through, explicit as in the JAX package (assign
    snapshots loop-carried state, which a replayed forward would read at its
    final value)."""
    _, fwd_outputs, _ = fwd_structure(op)
    gsrc = fwd_outputs['Out'][0] + GRAD_SUFFIX
    gnames = op.output('X' + GRAD_SUFFIX)
    if ctx.has(gsrc) and gnames and gnames[0]:
        ctx.store(gnames[0], ctx.lookup(gsrc))


@register_lowering('assign_value')
def _assign_value(ctx, op):
    arr = np.asarray(op.attrs['values']).reshape(tuple(op.attrs['shape']))
    ctx.set(op, 'Out', torch.as_tensor(arr).to(
        device=ctx.device, dtype=_torch_dtype(op.attrs.get('dtype'))))


@register_lowering('top_k')
def _top_k(ctx, op):
    values, indices = torch.topk(ctx.get(op, 'X'), op.attrs['k'], dim=-1)
    ctx.set(op, 'Out', values)
    ctx.set(op, 'Indices', indices.to(torch.int64))
