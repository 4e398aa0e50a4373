"""Math op lowerings (counterpart of ``paddle_tpu/ops/math_ops.py``): ``mul``,
``matmul``, the ``elementwise_*`` broadcast family, ``sum`` and ``scale``
(each also over sparse ``SparseRows`` gradients), ``mean``, the
``reduce_*`` family (sum, mean, max, min, prod), the unary ``pow``
(``x ** factor``, which the ``pow`` activation layer builds), ``clip``,
``clip_by_norm``, ``sign`` (which ``fluid/clip.py`` and the L1 regularizer
build), ``cos_sim``, ``cumsum`` and the norms ``squared_l2_norm``,
``squared_l2_distance``, ``l1_norm`` and ``norm``.

``mul``'s and ``matmul``'s product is ``registry.amp_matmul``:
``torch.matmul``, in bf16 under AMP, as the JAX package leaves its
product to XLA.  Under AMP the ``elementwise_*`` ops compute a bf16
activation with an f32 operand in bf16 (``amp_harmonize``).
``elementwise_mod`` and ``elementwise_floordiv`` follow Python's signs
(``jnp.mod``, ``jnp.floor_divide``), not C's.

Under data parallelism ``mean``, ``reduce_sum`` and ``reduce_mean`` over
the rows that ranks split reduce the global batch: local sums and counts
all-reduced in one collective, divided by the global count; the means'
grads scale the cotangent by the local count over the global one
(``registry.dp_scaled_grad``), and ``reduce_sum``'s generic grad, the
broadcast of its cotangent, needs nothing.  ``reduce_max``, ``reduce_min``
and ``reduce_prod`` over those rows raise.
"""

import math
import warnings

import torch

from .registry import (register_lowering, register_grad_lowering,
                       amp_matmul, amp_harmonize, declare_dp_aware,
                       dp_scaled_grad, SAMPLE_MASK_NAME)
from .sparse import SparseRows, sparse_add


@register_lowering('mul')
def _mul(ctx, op):
    x = ctx.get(op, 'X')
    y = ctx.get(op, 'Y')
    xn = op.attrs.get('x_num_col_dims', 1)
    yn = op.attrs.get('y_num_col_dims', 1)
    rows = math.prod(y.shape[:yn]) if yn > 0 else 1
    y2 = torch.reshape(y, (rows, -1))
    k = y2.shape[0]
    # choose x's split point from the right so trailing dims contract with k
    # (a padded runtime rank may exceed the desc rank)
    split = x.dim()
    acc = 1
    while split > 0 and acc != k:
        split -= 1
        acc *= x.shape[split]
    if acc != k:
        split = xn  # fall back to declared semantics (will raise clearly)
    x2 = torch.reshape(x, (-1, math.prod(x.shape[split:])))
    out = amp_matmul(x2, y2)
    ctx.set(op, 'Out', torch.reshape(
        out, tuple(x.shape[:split]) + tuple(y.shape[yn:])))


@register_lowering('matmul')
def _matmul(ctx, op):
    """Batched matmul with ``transpose_X``/``transpose_Y`` and ``alpha``: a
    1-D operand is promoted (a row for X, a column for Y) and squeezed back,
    batch dims broadcast (``torch.matmul``'s rules, as ``jnp.matmul``'s).
    The product is ``amp_matmul``, as ``mul``'s."""
    x = ctx.get(op, 'X')
    y = ctx.get(op, 'Y')
    squeeze_front = x.dim() == 1
    squeeze_back = y.dim() == 1
    if squeeze_front:
        x = x[None, :]
    if squeeze_back:
        y = y[:, None]
    if op.attrs.get('transpose_X', False):
        x = torch.transpose(x, -1, -2)
    if op.attrs.get('transpose_Y', False):
        y = torch.transpose(y, -1, -2)
    out = amp_matmul(x, y)
    alpha = op.attrs.get('alpha', 1.0)
    if alpha != 1.0:
        # alpha rounded to the product's dtype first, as jnp.asarray does
        out = out * float(torch.tensor(alpha, dtype=out.dtype))
    if squeeze_front:
        out = torch.squeeze(out, -2)
    if squeeze_back:
        out = torch.squeeze(out, -1)
    ctx.set(op, 'Out', out)


def _bcast_y(x, y, axis):
    """Reference broadcast: Y's shape aligns into X starting at `axis`;
    axis=-1 aligns trailing dims.  If the requested axis does not fit, fall
    back to trailing alignment."""
    if x.shape == y.shape:
        return y
    # trim trailing 1s of y (fluid allows y shape (C,1,1) matching mid dims)
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1 and len(yshape) > 1:
        yshape = yshape[:-1]

    def _aligned(ax):
        if ax < 0 or ax + len(yshape) > x.dim():
            return None
        if any(ys not in (1, x.shape[ax + i])
               for i, ys in enumerate(yshape)):
            return None
        return [1] * ax + yshape + [1] * (x.dim() - ax - len(yshape))

    if axis == -1 or axis is None:
        axis = x.dim() - len(yshape)
    new_shape = _aligned(axis)
    if new_shape is None:
        new_shape = _aligned(x.dim() - len(yshape))
    if new_shape is None:
        return y  # let torch's own broadcasting rules apply (or raise)
    return torch.reshape(y, new_shape)


def _register_elementwise(name, fn):
    @register_lowering('elementwise_' + name)
    def _lower(ctx, op, fn=fn):
        x = ctx.get(op, 'X')
        y = ctx.get(op, 'Y')
        axis = op.attrs.get('axis', -1)
        # the axis attr was chosen for X's DECLARED rank; when the runtime
        # rank differs the only meaningful alignment is trailing
        xd = ctx.var_desc(op.input('X')[0])
        if xd is not None and xd.shape and len(xd.shape) != x.dim():
            axis = -1
        y = _bcast_y(x, y, axis)
        # a bf16 activation and an f32 parameter (a bias, a scale) compute
        # in bf16 under AMP: promotion would widen the activation again
        x, y = amp_harmonize(x, y)
        ctx.set(op, 'Out', fn(x, y))


_register_elementwise('add', torch.add)
_register_elementwise('sub', torch.sub)
_register_elementwise('mul', torch.mul)
_register_elementwise('div', torch.div)
_register_elementwise('max', torch.maximum)
_register_elementwise('min', torch.minimum)
_register_elementwise('pow', torch.pow)
_register_elementwise('mod', torch.remainder)
_register_elementwise(
    'floordiv', lambda x, y: torch.div(x, y, rounding_mode='floor'))


@register_lowering('sum')
def _sum(ctx, op):
    """The backward pass sums renamed gradient parts: SparseRows parts
    concatenate, a dense part and a sparse part give a dense sum."""
    xs = [ctx.env[n] for n in op.input('X')]
    out = xs[0]
    for x in xs[1:]:
        out = sparse_add(out, x)
    ctx.set(op, 'Out', out)


@register_lowering('scale')
def _scale(ctx, op):
    x = ctx.get(op, 'X')
    if isinstance(x, SparseRows):
        # a sparse gradient scales its values
        if op.attrs.get('bias', 0.0) != 0.0:
            raise NotImplementedError(
                'scale with bias!=0 on a SelectedRows value')
        ctx.set(op, 'Out', x.scale(op.attrs.get('scale', 1.0)))
        return
    scale = op.attrs.get('scale', 1.0)
    bias = op.attrs.get('bias', 0.0)
    if op.attrs.get('bias_after_scale', True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.set(op, 'Out', out)


def _batch_mask_for(ctx, op, x):
    """The ragged-batch sample mask, iff X is batch-led (run_op's
    provenance): a weight-derived tensor whose dim 0 merely coincides with
    the padded batch never masks.  A value of batch ancestry whose dim 0 is
    a multiple of the batch (a batch flattened into its rows before the
    loss) cannot be masked, and is warned of: its padding rows count."""
    mask = ctx.env.get(SAMPLE_MASK_NAME)
    if mask is None or x.dim() < 1:
        return None
    name = op.input('X')[0]
    if x.shape[0] == mask.shape[0] and name in ctx.batch_led:
        return torch.reshape(mask.to(x.dtype),
                             (mask.shape[0], ) + (1, ) * (x.dim() - 1))
    if (name in ctx.batch_tainted and x.shape[0] != mask.shape[0]
            and x.shape[0] % mask.shape[0] == 0):
        warnings.warn(
            'ragged-batch mask cannot reach %r over %r: its leading dim %d '
            'looks like a flattened batch (the mask covers %d rows), so the '
            'padding rows count in this reduction; keep the batch on dim 0 '
            'through the loss, or drop the ragged tail'
            % (op.type, name, x.shape[0], mask.shape[0]))
    return None


def _dp_mean(ctx, op, total, count, local_denom, count_scale=1):
    """Under data parallelism: the global mean from this rank's ``total``
    and ``count`` (all-reduced together; the denominator is the global
    count, at least 1, times ``count_scale``), with the cotangent scale of
    its grad, ``local_denom`` over the global denominator, left for
    ``dp_scaled_grad``."""
    total, count = ctx.global_sum(total, count.to(total.dtype))
    denom = torch.clamp_min(count, 1) * count_scale
    ctx.dp_grad_scale[op.output('Out')[0]] = local_denom / denom
    return total / denom


@register_lowering('mean')
def _mean(ctx, op):
    # fluid MeanOp fixes the output dim to {1}
    x = ctx.get(op, 'X')
    m = _batch_mask_for(ctx, op, x)
    split = ctx.dp_split(op.input('X')[0])
    if m is not None:
        # a padded lot: the padding rows count neither in the sum nor in
        # the number of elements
        per_row = math.prod(x.shape[1:])
        total, count = torch.sum(x * m), torch.sum(m)
        denom = torch.clamp_min(count, 1) * per_row
        out = _dp_mean(ctx, op, total, count, denom, per_row) if split \
            else total / denom
        ctx.set(op, 'Out', torch.reshape(out, (1, )))
        return
    if split:
        n = torch.full((), x.numel(), dtype=x.dtype, device=x.device)
        out = _dp_mean(ctx, op, torch.sum(x), n, n)
    else:
        out = torch.mean(x)
    ctx.set(op, 'Out', torch.reshape(out, (1, )))


register_grad_lowering('mean')(dp_scaled_grad('mean', 'Out'))


def _prod_over(x, dim, keepdim):
    """``torch.prod`` over several dims (it takes one): the reduced dims
    moved last and flattened into one."""
    kept = [d for d in range(x.dim()) if d not in dim]
    flat = torch.reshape(x.permute(*kept, *dim),
                         tuple(x.shape[d] for d in kept) + (-1, ))
    out = torch.prod(flat, dim=-1)
    if keepdim:
        out = torch.reshape(out, tuple(1 if d in dim else x.shape[d]
                                       for d in range(x.dim())))
    return out


_REDUCERS = {
    'sum': torch.sum, 'mean': torch.mean,
    # amax and amin split a tied extreme's gradient evenly, as jax.vjp of
    # jnp.max does (torch.max(dim=) gives it all to one)
    'max': torch.amax, 'min': torch.amin, 'prod': _prod_over,
}


def _register_reduce(name):
    @register_lowering('reduce_' + name)
    def _lower(ctx, op, fn=_REDUCERS[name]):
        """Over ``dim`` (every dim with ``reduce_all``); a full reduction
        without ``keep_dim`` gives the rank-1 [1] that fluid keeps.  Over
        the batch dim of a padded lot, ``reduce_sum`` and ``reduce_mean``
        leave the padding rows out (the mean divides by the real rows times
        the other reduced dims); max, min and prod are not masked."""
        x = ctx.get(op, 'X')
        keep = op.attrs.get('keep_dim', False)
        if op.attrs.get('reduce_all', False):
            dims = tuple(range(x.dim()))
        else:
            dim = op.attrs.get('dim', [0])
            dims = tuple(d % x.dim()
                         for d in ([dim] if isinstance(dim, int) else dim))
        m = None
        split = 0 in dims and ctx.dp_split(op.input('X')[0])
        if split and name not in ('sum', 'mean'):
            raise NotImplementedError(
                'reduce_%s over the rows that data-parallel ranks split is '
                'not dp-aware: its local value would pass for the global '
                'one' % name)
        if name in ('sum', 'mean') and 0 in dims:
            m = _batch_mask_for(ctx, op, x)
        if not dims:
            out = x  # no dim to reduce over, as jnp's axis=()
        elif m is not None:
            out = torch.sum(x * m, dim=dims, keepdim=keep)
            if name == 'mean':
                other = math.prod(x.shape[d] for d in dims if d != 0)
                count = torch.sum(m)
                denom = torch.clamp_min(count, 1) * other
                out = _dp_mean(ctx, op, out, count, denom, other) if split \
                    else out / denom
            elif split:
                out, = ctx.global_sum(out)
        elif split:
            out = torch.sum(x, dim=dims, keepdim=keep)
            if name == 'mean':
                n = torch.full((), math.prod(x.shape[d] for d in dims),
                               dtype=x.dtype, device=x.device)
                out = _dp_mean(ctx, op, out, n, n)
            else:
                out, = ctx.global_sum(out)
        else:
            out = fn(x, dim=dims, keepdim=keep)
        if op.attrs.get('reduce_all', False) and not keep:
            out = torch.reshape(out, (1, ))
        ctx.set(op, 'Out', out)


for _name in _REDUCERS:
    _register_reduce(_name)
del _name
register_grad_lowering('reduce_mean')(dp_scaled_grad('reduce_mean', 'Out'))
declare_dp_aware('mean')


def _reduce_keeps_rows(ctx, op):
    """A reduction over other dims than dim 0 keeps the split rows."""
    ndim = ctx.env[op.input('X')[0]].dim()
    dim = op.attrs.get('dim', [0])
    dims = {d % ndim for d in ([dim] if isinstance(dim, int) else dim)}
    keeps = not op.attrs.get('reduce_all', False) and 0 not in dims
    return ('Out', ) if keeps else ()


declare_dp_aware(*('reduce_' + n for n in _REDUCERS),
                 rows=_reduce_keeps_rows)


@register_lowering('pow')
def _pow(ctx, op):
    ctx.set(op, 'Out', torch.pow(ctx.get(op, 'X'), op.attrs.get('factor', 1.0)))


@register_lowering('clip')
def _clip(ctx, op):
    x = ctx.get(op, 'X')
    ctx.set(op, 'Out', torch.clamp(x, op.attrs.get('min', float('-inf')),
                                   op.attrs.get('max', float('inf'))))


@register_lowering('clip_by_norm')
def _clip_by_norm(ctx, op):
    """X scaled to ``max_norm`` where its 2-norm is larger."""
    x = ctx.get(op, 'X')
    max_norm = op.attrs['max_norm']
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp_min(norm, 1e-12),
                        torch.ones((), dtype=x.dtype, device=x.device))
    ctx.set(op, 'Out', x * scale)


@register_lowering('sign')
def _sign(ctx, op):
    ctx.set(op, 'Out', torch.sign(ctx.get(op, 'X')))


@register_lowering('cos_sim')
def _cos_sim(ctx, op):
    """Row-wise cosine similarity (reference operators/cos_sim_op.cc); Y
    broadcasts when it has one row."""
    x = ctx.get(op, 'X')
    y = ctx.get(op, 'Y')
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    dot = torch.sum(x * y, dim=-1, keepdim=True)  # broadcasts a [1, D] y
    ctx.set(op, 'Out', dot / torch.clamp_min(xn * yn, 1e-12))
    ctx.set(op, 'XNorm', xn)
    ctx.set(op, 'YNorm', yn)


@register_lowering('squared_l2_norm')
def _squared_l2_norm(ctx, op):
    ctx.set(op, 'Out', torch.reshape(
        torch.sum(torch.square(ctx.get(op, 'X'))), (1, )))


@register_lowering('squared_l2_distance')
def _squared_l2_distance(ctx, op):
    """Each row's squared distance; Y broadcasts when it has one row."""
    sub = ctx.get(op, 'X') - ctx.get(op, 'Y')
    ctx.set(op, 'sub_result', sub)
    ctx.set(op, 'Out', torch.sum(torch.square(sub), dim=-1, keepdim=True))


@register_lowering('cumsum')
def _cumsum(ctx, op):
    """The running sum along ``axis`` in X's dtype, ``exclusive`` without
    each element itself, ``reverse`` from the end."""
    x = ctx.get(op, 'X')
    axis = op.attrs.get('axis', -1)
    reverse = op.attrs.get('reverse', False)
    if reverse:
        x = torch.flip(x, (axis, ))
    out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if op.attrs.get('exclusive', False):
        out = out - x
    if reverse:
        out = torch.flip(out, (axis, ))
    ctx.set(op, 'Out', out)


@register_lowering('l1_norm')
def _l1_norm(ctx, op):
    """The sum of |X|, a 0-d tensor as the JAX package's."""
    ctx.set(op, 'Out', torch.sum(torch.abs(ctx.get(op, 'X'))))


@register_lowering('norm')
def _norm(ctx, op):
    """X over its 2-norm along ``axis`` (``epsilon`` under the root)."""
    x = ctx.get(op, 'X')
    norm = torch.sqrt(torch.sum(torch.square(x),
                                dim=op.attrs.get('axis', -1), keepdim=True)
                      + op.attrs.get('epsilon', 1e-10))
    ctx.set(op, 'Norm', norm)
    ctx.set(op, 'Out', x / norm)
