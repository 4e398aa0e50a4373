"""Tensor creation / manipulation op lowerings (counterpart of
``paddle_tpu/ops/tensor_ops.py``).

Random ops draw from the context's ``torch.Generator`` (the executor seeds
it from ``program.random_seed``), or from a generator of their own when the
op carries a nonzero ``seed`` attr.  Torch and JAX streams differ, so the
same seed gives other numbers than the JAX package.
"""

import weakref

import numpy as np
import torch

from .registry import (register_lowering, register_grad_lowering,
                       fwd_structure, GRAD_SUFFIX, declare_uncapturable)
from ..fluid import core

# lowerings a CUDA graph capture cannot hold: the block runs eagerly
for _op_type in ('uniform_random', 'gaussian_random'):
    declare_uncapturable(
        _op_type, 'draws from a generator of its own (a nonzero seed attr), '
        'which a replay would not draw afresh',
        when=lambda op: bool(op.attrs.get('seed', 0)))
declare_uncapturable('reshape', 'reads its Shape input on the host',
                     when=lambda op: bool(op.input('Shape')))


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
    shape = tuple(op.attrs.get('shape', [1]))
    value = op.attrs.get('value', 0.0)
    ctx.set(op, 'Out', torch.full(shape, value,
                                  dtype=_torch_dtype(op.attrs.get('dtype')),
                                  device=ctx.device))
    if shape == (1, ):  # a scalar: its value is known on the host
        ctx.concrete[op.output('Out')[0]] = value


@register_lowering('fill_zeros_like')
def _fill_zeros_like(ctx, op):
    ctx.set(op, 'Out', torch.zeros_like(ctx.get(op, 'X')))


@register_lowering('fill_constant_batch_size_like')
def _fill_constant_batch_size_like(ctx, op):
    """A constant whose dim ``output_dim_idx`` is Input's dim
    ``input_dim_idx``."""
    ref = ctx.get(op, 'Input')
    shape = list(op.attrs.get('shape'))
    shape[op.attrs.get('output_dim_idx', 0)] = \
        ref.shape[op.attrs.get('input_dim_idx', 0)]
    ctx.set(op, 'Out', torch.full(tuple(shape), op.attrs.get('value', 0.0),
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


def _carry_concrete(ctx, op, fn=lambda v: v):
    """Out's known host value: ``fn`` of X's, or none."""
    out_name = op.output('Out')[0]
    cin = ctx.concrete.get(op.input('X')[0])
    if cin is not None:
        ctx.concrete[out_name] = fn(cin)
    else:
        ctx.concrete.pop(out_name, None)


@register_lowering('assign')
def _assign(ctx, op):
    ctx.set(op, 'Out', ctx.get(op, 'X'))
    _carry_concrete(ctx, op)


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


# assign_value's tensors, by op: (program version, {(device, dtype): tensor})
_ASSIGNED = weakref.WeakKeyDictionary()


@register_lowering('assign_value')
def _assign_value(ctx, op):
    """The attr's values on the place.  The copy from host memory, which a
    CUDA graph capture cannot hold, is made once for each op, program
    version, device and dtype (at the eager call the executor makes before
    it captures a block); every call hands out a copy of it made on the
    device.  ``set_attr`` bumps the program's version, so new values are
    copied anew."""
    dtype = _torch_dtype(op.attrs.get('dtype'))
    version = op.block.program._version
    seen = _ASSIGNED.get(op)
    if seen is None or seen[0] != version:
        seen = _ASSIGNED[op] = (version, {})
    made = seen[1]
    key = (str(ctx.device), dtype)
    if key not in made:
        arr = np.asarray(op.attrs['values']).reshape(
            tuple(op.attrs['shape']))
        made[key] = torch.as_tensor(arr).to(device=ctx.device, dtype=dtype)
    ctx.set(op, 'Out', made[key].clone())


@register_lowering('cast')
def _cast(ctx, op):
    ctx.set(op, 'Out', ctx.get(op, 'X').to(
        _torch_dtype(op.attrs.get('out_dtype'))))


@register_lowering('concat')
def _concat(ctx, op):
    ctx.set(op, 'Out', torch.cat([ctx.env[n] for n in op.input('X')],
                                 dim=op.attrs.get('axis', 0)))


@register_lowering('gather')
def _gather(ctx, op):
    """Rows of X at Index (flattened)."""
    index = torch.reshape(ctx.get(op, 'Index'), (-1, ))
    ctx.set(op, 'Out', torch.index_select(ctx.get(op, 'X'), 0, index))


@register_lowering('expand')
def _expand(ctx, op):
    """X tiled ``expand_times`` along each dim (``jnp.tile``)."""
    ctx.set(op, 'Out', torch.tile(ctx.get(op, 'X'),
                                  tuple(op.attrs['expand_times'])))


@register_lowering('one_hot')
def _one_hot(ctx, op):
    """float32 rows of ``depth``: 1 where X equals the column index, as
    ``jax.nn.one_hot`` compares X against an iota of X's own dtype, so a
    float X (a position counter) works and a value out of range (or not
    whole) gives a zero row.  A trailing dim of 1 is dropped first."""
    x = ctx.get(op, 'X')
    depth = int(op.attrs['depth'])
    if x.dim() and x.shape[-1] == 1:
        x = torch.reshape(x, tuple(x.shape[:-1]))
    cols = torch.arange(depth, device=x.device).to(x.dtype)
    ctx.set(op, 'Out', (x[..., None] == cols).to(torch.float32))


@register_lowering('top_k')
def _top_k(ctx, op):
    values, indices = torch.topk(ctx.get(op, 'X'), op.attrs['k'], dim=-1)
    ctx.set(op, 'Out', values)
    ctx.set(op, 'Indices', indices.to(torch.int64))


@register_lowering('increment')
def _increment(ctx, op):
    """Out = X + step in X's dtype (an integer counter adds the step's
    integer part), and X's known host value carried forward.  Functional:
    where Out is X (``in_place``, the step counter), the executor writes
    the new value into the var's state buffer, so a replayed graph
    advances the scope's counter."""
    x = ctx.get(op, 'X')
    step = op.attrs.get('step', 1.0)
    ctx.set(op, 'Out', x + (step if x.is_floating_point() else int(step)))
    _carry_concrete(ctx, op, lambda v: v + step)


def _register_compare(name, fn):
    @register_lowering(name)
    def _lower(ctx, op, fn=fn):
        ctx.set(op, 'Out', fn(ctx.get(op, 'X'), ctx.get(op, 'Y')))


_register_compare('less_than', torch.lt)
_register_compare('less_equal', torch.le)
_register_compare('greater_than', torch.gt)
_register_compare('greater_equal', torch.ge)
_register_compare('equal', torch.eq)
_register_compare('not_equal', torch.ne)
_register_compare('logical_and', torch.logical_and)
_register_compare('logical_or', torch.logical_or)
_register_compare('logical_xor', torch.logical_xor)


@register_lowering('logical_not')
def _logical_not(ctx, op):
    ctx.set(op, 'Out', torch.logical_not(ctx.get(op, 'X')))


@register_lowering('where_select')
def _where_select(ctx, op):
    """X where the one-element Cond holds, else Y (piecewise_decay's
    select chain)."""
    cond = torch.reshape(ctx.get(op, 'Cond'), ()).bool()
    ctx.set(op, 'Out', torch.where(cond, ctx.get(op, 'X'), ctx.get(op, 'Y')))


@register_lowering('is_empty')
def _is_empty(ctx, op):
    """[1] bool: X has no elements (a fill on the device: the count is a
    host shape)."""
    ctx.set(op, 'Out', torch.full((1, ), ctx.get(op, 'X').numel() == 0,
                                  dtype=torch.bool, device=ctx.device))
