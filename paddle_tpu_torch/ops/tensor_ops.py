"""Tensor creation / manipulation op lowerings (counterpart of
``paddle_tpu/ops/tensor_ops.py``).

Random ops draw from the context's ``torch.Generator`` (the executor seeds
it from ``program.random_seed``), or from a generator of their own when the
op carries a nonzero ``seed`` attr.  Torch and JAX streams differ, so the
same seed gives other numbers than the JAX package.

The shape ops (``transpose``, ``split``, ``slice``, ``unstack``, ...) give
views where torch can; every lowering is functional, so a view is only
ever read, and ``torch.reshape`` copies a view it cannot view again.  The
``*2`` forms also write ``XShape``, an empty [0, *X.shape] tensor, as the
JAX package does.
"""

import math
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from .registry import (register_lowering, register_grad_lowering,
                       fwd_structure, GRAD_SUFFIX, declare_uncapturable)
from ..fluid import core

# lowerings a CUDA graph capture cannot hold: the block runs eagerly
for _op_type in ('uniform_random', 'gaussian_random',
                 'truncated_gaussian_random',
                 'uniform_random_batch_size_like',
                 'gaussian_random_batch_size_like', 'random_crop'):
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


def _batch_shape(op, ref):
    """The ``*_batch_size_like`` ops' shape: the attr with its dim
    ``output_dim_idx`` taken from Input's dim ``input_dim_idx``."""
    shape = list(op.attrs.get('shape'))
    shape[op.attrs.get('output_dim_idx', 0)] = \
        ref.shape[op.attrs.get('input_dim_idx', 0)]
    return tuple(shape)


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
    ctx.set(op, 'Out', torch.full(_batch_shape(op, ctx.get(op, 'Input')),
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


def _set_list(ctx, op, slot, values):
    for name, value in zip(op.output(slot), values):
        ctx.env[name] = value


def write_xshape(ctx, op, x):
    """The ``*2`` ops' XShape output: X's shape behind a 0 dim."""
    ctx.set(op, 'XShape', torch.zeros((0, ) + tuple(x.shape), dtype=x.dtype,
                                      device=x.device))


# the standard normal's CDF at -2 and 2: truncated_gaussian_random draws
# uniformly between them and maps back through the inverse CDF
_PHI_LO, _PHI_HI = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), \
    0.5 * (1 + math.erf(2 / math.sqrt(2)))


@register_lowering('truncated_gaussian_random')
def _truncated_gaussian_random(ctx, op):
    """mean + std * a standard normal truncated to [-2, 2], as
    ``jax.random.truncated_normal(key, -2, 2)``: a uniform draw between
    the normal's CDF at the bounds, through the inverse CDF."""
    u = torch.empty(tuple(op.attrs.get('shape')), dtype=torch.float32,
                    device=ctx.device)
    u.uniform_(_PHI_LO, _PHI_HI, generator=_generator(ctx, op))
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0), -2.0, 2.0)
    out = op.attrs.get('mean', 0.0) + op.attrs.get('std', 1.0) * z
    ctx.set(op, 'Out', out.to(_torch_dtype(op.attrs.get('dtype'))))


@register_lowering('uniform_random_batch_size_like')
def _uniform_random_batch_size_like(ctx, op):
    out = torch.empty(_batch_shape(op, ctx.get(op, 'Input')),
                      dtype=torch.float32, device=ctx.device)
    out.uniform_(op.attrs.get('min', -1.0), op.attrs.get('max', 1.0),
                 generator=_generator(ctx, op))
    ctx.set(op, 'Out', out.to(_torch_dtype(op.attrs.get('dtype'))))


@register_lowering('gaussian_random_batch_size_like')
def _gaussian_random_batch_size_like(ctx, op):
    out = torch.empty(_batch_shape(op, ctx.get(op, 'Input')),
                      dtype=torch.float32, device=ctx.device)
    out.normal_(op.attrs.get('mean', 0.0), op.attrs.get('std', 1.0),
                generator=_generator(ctx, op))
    ctx.set(op, 'Out', out.to(_torch_dtype(op.attrs.get('dtype'))))


@register_lowering('random_crop')
def _random_crop(ctx, op):
    """A window of ``shape`` over X's trailing dims at a start drawn
    uniformly in each (the leading dims whole).  The starts stay on the
    device: each dim is gathered at start + arange(size), so a capture
    holds the op and every replay draws new starts."""
    out = ctx.get(op, 'X')
    shape = op.attrs['shape']
    nlead = out.dim() - len(shape)
    g = _generator(ctx, op)
    for i, size in enumerate(shape):
        dim = nlead + i
        limit = max(out.shape[dim] - size, 0)
        start = torch.randint(0, limit + 1, (1, ), generator=g,
                              device=out.device)
        out = torch.index_select(
            out, dim, start + torch.arange(size, device=out.device))
    ctx.set(op, 'Out', out)


def _infer_shape(x, shape):
    """``shape`` with each 0 replaced by X's dim at that place."""
    return tuple(x.shape[i] if s == 0 else s for i, s in enumerate(shape))


@register_lowering('reshape2')
def _reshape2(ctx, op):
    x = ctx.get(op, 'X')
    ctx.set(op, 'Out', torch.reshape(x, _infer_shape(x, op.attrs['shape'])))
    write_xshape(ctx, op, x)


@register_lowering('transpose')
def _transpose(ctx, op):
    ctx.set(op, 'Out', ctx.get(op, 'X').permute(*op.attrs['axis']))


@register_lowering('transpose2')
def _transpose2(ctx, op):
    x = ctx.get(op, 'X')
    ctx.set(op, 'Out', x.permute(*op.attrs['axis']))
    write_xshape(ctx, op, x)


@register_lowering('squeeze')
def _squeeze(ctx, op):
    """The ``axes`` of size 1 dropped (the others kept), or every dim of
    size 1 when ``axes`` is empty."""
    x = ctx.get(op, 'X')
    axes = op.attrs.get('axes', [])
    if axes:
        out = torch.squeeze(x, tuple(a for a in axes if x.shape[a] == 1))
    else:
        out = torch.squeeze(x)
    ctx.set(op, 'Out', out)


@register_lowering('split')
def _split(ctx, op):
    """``num`` equal parts, or parts cut where the ``sections`` sum up (the
    last part runs to the end), as ``jnp.split``."""
    x = ctx.get(op, 'X')
    axis = op.attrs.get('axis', 0)
    num = op.attrs.get('num', 0)
    if num:
        if x.shape[axis] % num:
            raise ValueError('split: dim %d of size %d does not divide into '
                             '%d equal parts' % (axis, x.shape[axis], num))
        outs = torch.tensor_split(x, num, dim=axis)
    else:
        cuts = np.cumsum(op.attrs.get('sections', []))[:-1]
        outs = torch.tensor_split(x, [int(c) for c in cuts], dim=axis)
    _set_list(ctx, op, 'Out', outs)


@register_lowering('shape')
def _shape(ctx, op):
    """Input's static shape as an int32 tensor, made by fills on the device
    (an item assignment would copy from the host, which a capture
    refuses), so a capture holds it."""
    x = ctx.get(op, 'Input')
    out = torch.empty((x.dim(), ), dtype=torch.int32, device=x.device)
    for i, size in enumerate(x.shape):
        out[i].fill_(size)
    ctx.set(op, 'Out', out)


@register_lowering('slice')
def _slice(ctx, op):
    """Python slicing along ``axes``: a negative start or end counts from
    the end, and an end past the dim stops at it."""
    x = ctx.get(op, 'Input')
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(op.attrs['axes'], op.attrs['starts'],
                          op.attrs['ends']):
        idx[ax] = slice(st, en)
    ctx.set(op, 'Out', x[tuple(idx)])


@register_lowering('stack')
def _stack(ctx, op):
    ctx.set(op, 'Y', torch.stack([ctx.env[n] for n in op.input('X')],
                                 dim=op.attrs.get('axis', 0)))


@register_lowering('unstack')
def _unstack(ctx, op):
    _set_list(ctx, op, 'Y', torch.unbind(ctx.get(op, 'X'),
                                         dim=op.attrs.get('axis', 0)))


@register_lowering('scatter')
def _scatter(ctx, op):
    """X with the rows at Ids (flattened) set to Updates' rows.  The order
    among repeated ids is unspecified, as in the JAX package."""
    ids = torch.reshape(ctx.get(op, 'Ids'), (-1, )).long()
    ctx.set(op, 'Out', ctx.get(op, 'X').index_put((ids, ),
                                                  ctx.get(op, 'Updates')))


@register_lowering('reverse')
def _reverse(ctx, op):
    axes = op.attrs['axis']
    axes = [axes] if isinstance(axes, int) else list(axes)
    ctx.set(op, 'Out', torch.flip(ctx.get(op, 'X'), axes))


@register_lowering('pad')
def _pad(ctx, op):
    """``paddings`` [before_0, after_0, before_1, ...] of ``pad_value``."""
    x = ctx.get(op, 'X')
    p = op.attrs['paddings']
    flat = []
    for i in reversed(range(x.dim())):  # F.pad takes the last dim first
        flat += [p[2 * i], p[2 * i + 1]]
    ctx.set(op, 'Out', F.pad(x, flat, value=op.attrs.get('pad_value', 0.0)))


@register_lowering('pad2d')
def _pad2d(ctx, op):
    """NCHW padded by [top, bottom, left, right]: a constant, or the
    ``reflect`` or ``edge`` mode of ``jnp.pad``."""
    x = ctx.get(op, 'X')
    p = op.attrs['paddings']
    mode = op.attrs.get('mode', 'constant')
    flat = [p[2], p[3], p[0], p[1]]
    if mode == 'constant':
        out = F.pad(x, flat, value=op.attrs.get('pad_value', 0.0))
    else:
        out = F.pad(x, flat, mode={'reflect': 'reflect',
                                   'edge': 'replicate'}[mode])
    ctx.set(op, 'Out', out)


@register_lowering('multiplex')
def _multiplex(ctx, op):
    """Row i of the X chosen by Ids[i]."""
    ids = torch.reshape(ctx.get(op, 'Ids'), (-1, )).long()
    xs = torch.stack([ctx.env[n] for n in op.input('X')], dim=0)  # K, N, ..
    rows = torch.arange(xs.shape[1], device=xs.device)
    ctx.set(op, 'Out', xs[ids, rows])


@register_lowering('label_smooth')
def _label_smooth(ctx, op):
    """(1 - epsilon) X + epsilon times PriorDist, or over the classes
    evenly."""
    x = ctx.get(op, 'X')
    eps = op.attrs.get('epsilon', 0.0)
    dist = ctx.get(op, 'PriorDist')
    if dist is not None:
        out = (1 - eps) * x + eps * torch.reshape(dist, (1, -1))
    else:
        out = (1 - eps) * x + eps / x.shape[-1]
    ctx.set(op, 'Out', out)


@register_lowering('argmax')
def _argmax(ctx, op):
    """The first index of the largest value along ``axis``."""
    ctx.set(op, 'Out', torch.argmax(ctx.get(op, 'X'),
                                    dim=op.attrs.get('axis', 0)))


@register_lowering('argmin')
def _argmin(ctx, op):
    ctx.set(op, 'Out', torch.argmin(ctx.get(op, 'X'),
                                    dim=op.attrs.get('axis', 0)))


@register_lowering('argsort')
def _argsort(ctx, op):
    """The sorted values and their indices along ``axis``; equal values
    keep their order (stable, as ``jnp.argsort``)."""
    out, idx = torch.sort(ctx.get(op, 'X'), dim=op.attrs.get('axis', -1),
                          stable=True)
    ctx.set(op, 'Indices', idx)
    ctx.set(op, 'Out', out)


@register_lowering('crop')
def _crop(ctx, op):
    """X from ``offsets`` over ``shape`` (or Y's shape)."""
    x = ctx.get(op, 'X')
    y = ctx.get(op, 'Y')
    shape = y.shape if y is not None else op.attrs.get('shape')
    idx = tuple(slice(o, o + s) for o, s in zip(op.attrs.get('offsets'),
                                                shape))
    ctx.set(op, 'Out', x[idx])


@register_lowering('isfinite')
def _isfinite(ctx, op):
    """[1] bool: every element of X is finite."""
    ctx.set(op, 'Out', torch.reshape(
        torch.all(torch.isfinite(ctx.get(op, 'X'))), (1, )))
