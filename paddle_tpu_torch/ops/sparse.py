"""Sparse (SelectedRows) gradients of the PyTorch port: counterpart of
``paddle_tpu/ops/sparse.py``.

A ``lookup_table`` op built with ``is_sparse=True`` gets a ``SparseRows``
gradient: one row id (int64 [N]) and one value row ([N, D]) for each
looked-up id, and the table's height.  The [V, D] dense gradient is never
made.  ``sgd``, ``momentum`` and ``adam`` update only the rows the
gradient touches (the reference's lazy SelectedRows kernels), and so do
``adagrad``, ``rmsprop``, ``ftrl`` and ``adadelta``: duplicate ids merge
into one row each (``merge_rows``), the touched rows of the parameter and
its accumulators are gathered, the dense update runs on them, and one
scatter writes them back.  ``adamax`` and ``decayed_adagrad`` run their
dense update on the dense form of the gradient and keep the untouched
rows (``lazy_apply``).  Untouched rows stay bitwise as
they were, and their moments do not decay.  The dense lane's gradient is
the same merge scattered into zeros, so the two forms sum a repeated id's
rows alike.

Everything keeps static shapes and never reads a device value on the host
(no ``unique``, ``nonzero`` or boolean-mask indexing), so a sparse step
can be captured as a CUDA graph and replayed.

The row-subset updates write into the parameter and accumulator tensors in
place when the op writes the var it reads (ParamOut = Param, as the
optimizers build it).  This is the counterpart of XLA's buffer donation in
the JAX package: an out-of-place scatter would copy the whole [V, D] table,
and each of its moments, at every step.

Not ported yet: the embedding cache's slab exchange.
"""

import torch

from .registry import (GRAD_SUFFIX, fwd_structure, register_grad_lowering,
                       register_lowering)

__all__ = ['SparseRows', 'sparse_add', 'merge_rows', 'lazy_apply',
           'sparsify_optimizer']


class SparseRows(object):
    """A row-subset gradient: ``rows`` (int64 [N]), ``values`` ([N, ...])
    and the dense height.  Rows may repeat; they then sum."""

    def __init__(self, rows, values, height):
        self.rows = rows
        self.values = values
        self.height = int(height)

    @property
    def dense_shape(self):
        return (self.height, ) + tuple(self.values.shape[1:])

    def to_dense(self):
        """The dense [height, ...] gradient (repeated rows accumulate, as
        the dense lane's gradient sums them)."""
        zeros = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                            device=self.values.device)
        return _scatter_rows(zeros, *merge_rows(self.rows, self.values,
                                                self.height))

    def touched_mask(self):
        """Boolean [height] mask of the rows present in this gradient."""
        m = torch.zeros((self.height, ), dtype=torch.bool,
                        device=self.rows.device)
        return m.index_put_((self.rows, ), torch.ones_like(self.rows,
                                                           dtype=torch.bool))

    def scale(self, s):
        return SparseRows(self.rows, self.values * s, self.height)

    def __repr__(self):
        return 'SparseRows(n=%s, height=%d, dim=%s)' % (
            self.values.shape[0], self.height, tuple(self.values.shape[1:]))


def sparse_add(a, b):
    """Gradient accumulation over dense tensors and SparseRows: two sparse
    parts concatenate, a dense and a sparse part give a dense sum."""
    if isinstance(a, list) and isinstance(b, list):
        # two tensor-array gradients: element by element
        return [sparse_add(x, y) for x, y in zip(a, b)]
    a_sparse = isinstance(a, SparseRows)
    b_sparse = isinstance(b, SparseRows)
    if a_sparse and b_sparse:
        return SparseRows(torch.cat([a.rows, b.rows]),
                          torch.cat([a.values, b.values]), a.height)
    if a_sparse:
        return b + a.to_dense()
    if b_sparse:
        return a + b.to_dense()
    return a + b


# ----------------------------------------------------------------------------
# lookup_table's grad: dense scatter-add, or SparseRows with is_sparse
# ----------------------------------------------------------------------------
@register_grad_lowering('lookup_table')
def _lookup_table_grad(ctx, op):
    fwd_inputs, fwd_outputs, fwd_attrs = fwd_structure(op)
    gnames = op.output('W' + GRAD_SUFFIX)
    if not gnames or not gnames[0]:
        return
    gname = gnames[0]
    w = ctx.lookup(fwd_inputs['W'][0])
    flat = torch.reshape(ctx.lookup(fwd_inputs['Ids'][0]), (-1, )).long()
    vals = torch.reshape(ctx.lookup(fwd_outputs['Out'][0] + GRAD_SUFFIX),
                         (flat.shape[0], w.shape[-1])).to(w.dtype)
    padding_idx = fwd_attrs.get('padding_idx', -1)
    if padding_idx is not None and padding_idx >= 0:
        vals = torch.where((flat == padding_idx)[:, None], 0.0, vals)
    if fwd_attrs.get('is_sparse', False):
        g = SparseRows(flat, vals, w.shape[0])
    else:
        # the merged rows scattered into zeros: each row's contributions
        # summed as the sparse lane sums them, in a fixed order (index_add_
        # would sum them by atomics, in any order)
        rows, merged = merge_rows(flat, vals, w.shape[0])
        g = _scatter_rows(torch.zeros_like(w), rows, merged)
    if ctx.has(gname):
        g = sparse_add(ctx.lookup(gname), g)
    ctx.store(gname, g)


# ----------------------------------------------------------------------------
# lazy row-subset optimizers
# ----------------------------------------------------------------------------
def merge_rows(rows, values, height):
    """Merge duplicate ids with static shapes: sort the ids (stably), sum
    each run of equal ids onto one slot, and park every leftover slot on
    the sentinel id ``height``, one past the table.

    Returns (slot_rows [N], merged [N, ...]): the first num-unique slots
    hold each unique id in ascending order and its summed values; the rest
    hold ``height`` and zeros.

    A run's sum is the difference of the f64 prefix sums at its two ends.
    Zipf ids make one run thousands of rows long, and an accumulating
    ``index_put_`` sums a run's rows one after another on the card (7x
    slower at a CTR batch, ``profile_ctr_merge.py``); the scan is parallel
    (taken along the last dim: along dim 0 PyTorch scans each column
    serially), deterministic, and in f64 its differences lose nothing at
    f32.  Each slot is written once; the rows that end (or start) no run
    write into a spare row."""
    n = rows.shape[0]
    if n == 0:
        return rows, values
    r, order = torch.sort(rows, stable=True)
    first = torch.ones((n, ), dtype=torch.bool, device=r.device)
    first[1:] = r[1:] != r[:-1]
    last = torch.ones((n, ), dtype=torch.bool, device=r.device)
    last[:-1] = first[1:]
    seg = torch.cumsum(first, 0) - 1  # the slot of each id's run
    slot_rows = torch.full((n, ), height, dtype=r.dtype,
                           device=r.device).index_put_((seg, ), r)
    v = torch.reshape(torch.index_select(values, 0, order), (n, -1)).double()
    prefix = torch.cumsum(v.t().contiguous(), 1).t()
    spare = torch.full_like(seg, n)
    ends = torch.zeros((n + 1, v.shape[1]), dtype=v.dtype, device=v.device)
    starts = torch.zeros_like(ends)
    ends.index_put_((torch.where(last, seg, spare), ), prefix)
    starts.index_put_((torch.where(first, seg, spare), ), prefix - v)
    merged = (ends[:n] - starts[:n]).to(values.dtype)
    return slot_rows, torch.reshape(merged, values.shape)


def _gather_rows(dense, rows):
    """``dense[rows]`` with the sentinel slots clamped onto the last row, as
    a gather clamps in the JAX package (their values are never written)."""
    return torch.index_select(dense, 0,
                              torch.clamp(rows, max=dense.shape[0] - 1))


def _scatter_rows(dense, rows, new_rows):
    """Write ``new_rows`` into ``dense`` at ``rows``, in place, skipping the
    sentinel slots of ``merge_rows``.  PyTorch has no scatter that drops an
    out-of-range index (one is a device assert), and a shape that depends
    on the count of real slots would read it on the host.  So each sentinel
    slot is pointed at slot 0's row and given slot 0's new value: slot 0
    always holds a real row (the smallest id), and duplicate writes of one
    value leave one result whatever their order."""
    real = rows < dense.shape[0]
    idx = torch.where(real, rows, rows[:1])
    keep = torch.reshape(real, (-1, ) + (1, ) * (new_rows.dim() - 1))
    vals = torch.where(keep, new_rows, new_rows[:1]).to(dense.dtype)
    return dense.index_put_((idx, ), vals)


def _target(ctx, op, slot, out_slot=None):
    """The tensor the update of input ``slot`` writes into: the input
    itself when the op writes back the var it reads (``out_slot``, by
    default ``<slot>Out``, names it), else a copy of it."""
    t = ctx.get(op, slot)
    outs = op.output(out_slot or slot + 'Out')
    return t if outs and outs[0] == op.input(slot)[0] else t.clone()


def _lr(ctx, op):
    return torch.reshape(ctx.get(op, 'LearningRate'), ())


def _rows_sgd(ctx, op, g):
    """SelectedRows SGD: the touched rows updated as the dense lowering
    updates them, p - lr * g, against the merged gradient.  The reference
    adds each looked-up row's -lr g into the table one by one; merged
    first, the sparse and dense forms agree bitwise wherever their
    gradients do."""
    p = _target(ctx, op, 'Param')
    rows, grad = merge_rows(g.rows, g.values, g.height)
    p_new = _gather_rows(p, rows) - _lr(ctx, op) * grad
    ctx.set(op, 'ParamOut', _scatter_rows(p, rows, p_new))


def _rows_momentum(ctx, op, g):
    """Lazy momentum: the dense update on the touched rows of param and
    velocity against the merged gradient; untouched rows' velocity does not
    decay."""
    p = _target(ctx, op, 'Param')
    vel = _target(ctx, op, 'Velocity')
    lr = _lr(ctx, op)
    mu = op.attrs['mu']
    rows, grad = merge_rows(g.rows, g.values, g.height)
    v_new = mu * _gather_rows(vel, rows) + grad
    if op.attrs.get('use_nesterov', False):
        p_new = _gather_rows(p, rows) - (grad + mu * v_new) * lr
    else:
        p_new = _gather_rows(p, rows) - lr * v_new
    ctx.set(op, 'ParamOut', _scatter_rows(p, rows, p_new))
    ctx.set(op, 'VelocityOut', _scatter_rows(vel, rows, v_new))


def _rows_adam(ctx, op, g):
    """Lazy Adam (the reference's SparseAdamFunctor): the moments update,
    and decay, only at the rows present in the gradient; O(rows x D) work a
    step."""
    p = _target(ctx, op, 'Param')
    m1 = _target(ctx, op, 'Moment1')
    m2 = _target(ctx, op, 'Moment2')
    b1p = torch.reshape(ctx.get(op, 'Beta1Pow'), ())
    b2p = torch.reshape(ctx.get(op, 'Beta2Pow'), ())
    lr = _lr(ctx, op)
    b1 = op.attrs.get('beta1', 0.9)
    b2 = op.attrs.get('beta2', 0.999)
    eps = op.attrs.get('epsilon', 1e-8)
    rows, grad = merge_rows(g.rows, g.values, g.height)
    m1_new = b1 * _gather_rows(m1, rows) + (1 - b1) * grad
    m2_new = b2 * _gather_rows(m2, rows) + (1 - b2) * torch.square(grad)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_new = _gather_rows(p, rows) - lr_t * m1_new / (torch.sqrt(m2_new) +
                                                     eps)
    ctx.set(op, 'ParamOut', _scatter_rows(p, rows, p_new))
    ctx.set(op, 'Moment1Out', _scatter_rows(m1, rows, m1_new))
    ctx.set(op, 'Moment2Out', _scatter_rows(m2, rows, m2_new))


def _rows_adagrad(ctx, op, g):
    """Row-subset Adagrad: the touched rows of param and moment updated
    against the merged gradient.  An untouched row's dense update adds 0,
    so the lazy and dense forms agree everywhere."""
    p = _target(ctx, op, 'Param')
    mom = _target(ctx, op, 'Moment')
    eps = op.attrs.get('epsilon', 1e-6)
    rows, grad = merge_rows(g.rows, g.values, g.height)
    m_new = _gather_rows(mom, rows) + torch.square(grad)
    p_new = _gather_rows(p, rows) - _lr(ctx, op) * grad / (
        torch.sqrt(m_new) + eps)
    ctx.set(op, 'ParamOut', _scatter_rows(p, rows, p_new))
    ctx.set(op, 'MomentOut', _scatter_rows(mom, rows, m_new))


def _rows_rmsprop(ctx, op, g):
    """Row-subset RMSProp: param, mean square and momentum updated at the
    touched rows only; an untouched row's mean square does not decay."""
    p = _target(ctx, op, 'Param')
    ms = _target(ctx, op, 'MeanSquare')
    mom = _target(ctx, op, 'Moment')
    eps = op.attrs.get('epsilon', 1e-10)
    decay = op.attrs.get('decay', 0.9)
    momentum = op.attrs.get('momentum', 0.0)
    rows, grad = merge_rows(g.rows, g.values, g.height)
    ms_new = decay * _gather_rows(ms, rows) + (1 - decay) * torch.square(grad)
    mom_new = momentum * _gather_rows(mom, rows) + \
        _lr(ctx, op) * grad / torch.sqrt(ms_new + eps)
    ctx.set(op, 'ParamOut', _scatter_rows(p, rows,
                                          _gather_rows(p, rows) - mom_new))
    ctx.set(op, 'MomentOut', _scatter_rows(mom, rows, mom_new))
    ctx.set(op, 'MeanSquareOut', _scatter_rows(ms, rows, ms_new))


def _rows_ftrl(ctx, op, g):
    """Row-subset FTRL: param and both accumulators updated at the touched
    rows only.  FTRL derives the param from its accumulators at each
    visit (a dense step with a zero gradient still moves a row), so the
    untouched rows keeping all three is the lazy semantics."""
    from .optimizer_ops import ftrl_update
    p = _target(ctx, op, 'Param')
    sq = _target(ctx, op, 'SquaredAccumulator', 'SquaredAccumOut')
    lin = _target(ctx, op, 'LinearAccumulator', 'LinearAccumOut')
    rows, grad = merge_rows(g.rows, g.values, g.height)
    p_new, sq_new, lin_new = ftrl_update(
        _gather_rows(p, rows), grad, _gather_rows(sq, rows),
        _gather_rows(lin, rows), _lr(ctx, op), op.attrs.get('l1', 0.0),
        op.attrs.get('l2', 0.0), op.attrs.get('lr_power', -0.5))
    ctx.set(op, 'ParamOut', _scatter_rows(p, rows, p_new))
    ctx.set(op, 'SquaredAccumOut', _scatter_rows(sq, rows, sq_new))
    ctx.set(op, 'LinearAccumOut', _scatter_rows(lin, rows, lin_new))


def _rows_adadelta(ctx, op, g):
    """Row-subset Adadelta (it takes no learning rate): param and both
    running averages updated at the touched rows only; an untouched row's
    averages do not decay."""
    p = _target(ctx, op, 'Param')
    asg = _target(ctx, op, 'AvgSquaredGrad')
    asu = _target(ctx, op, 'AvgSquaredUpdate')
    rho = op.attrs.get('rho', 0.95)
    eps = op.attrs.get('epsilon', 1e-6)
    rows, grad = merge_rows(g.rows, g.values, g.height)
    asu_rows = _gather_rows(asu, rows)
    asg_new = rho * _gather_rows(asg, rows) + (1 - rho) * torch.square(grad)
    update = -torch.sqrt((asu_rows + eps) / (asg_new + eps)) * grad
    asu_new = rho * asu_rows + (1 - rho) * torch.square(update)
    ctx.set(op, 'ParamOut', _scatter_rows(p, rows,
                                          _gather_rows(p, rows) + update))
    ctx.set(op, 'AvgSquaredGradOut', _scatter_rows(asg, rows, asg_new))
    ctx.set(op, 'AvgSquaredUpdateOut', _scatter_rows(asu, rows, asu_new))


# the optimizers with a row-subset update; the others take lazy_apply
_ROW_SUBSET_APPLY = {
    'sgd': _rows_sgd,
    'momentum': _rows_momentum,
    'adam': _rows_adam,
    'adagrad': _rows_adagrad,
    'rmsprop': _rows_rmsprop,
    'ftrl': _rows_ftrl,
    'adadelta': _rows_adadelta,
}


def lazy_apply(ctx, op, dense_fn):
    """Run a dense optimizer lowering against the dense form of a SparseRows
    gradient, then keep the untouched rows of every row-shaped output slot
    as they were: the lazy semantics for an optimizer with no row-subset
    update (O(V x D) a step).  A dense gradient runs ``dense_fn`` as it
    is."""
    g = ctx.get(op, 'Grad')
    if not isinstance(g, SparseRows):
        return dense_fn(ctx, op)
    grad_name = op.input('Grad')[0]
    # the inputs an output may alias (ParamOut <- Param, ...), for masking
    in_by_slot = {s: [ctx.lookup(n) for n in op.input(s)]
                  for s in op.inputs if all(ctx.has(n) for n in op.input(s))}
    ctx.store(grad_name, g.to_dense())
    try:
        dense_fn(ctx, op)
    finally:
        ctx.store(grad_name, g)
    touched = g.touched_mask()
    for out_slot in op.outputs:
        in_slot = out_slot[:-3] if out_slot.endswith('Out') else None
        if in_slot is None or in_slot not in in_by_slot:
            continue
        for n, old in zip(op.output(out_slot), in_by_slot[in_slot]):
            if not ctx.has(n):
                continue
            new = ctx.lookup(n)
            shape = tuple(new.shape)
            if not shape or shape[0] != g.height or \
                    shape != tuple(old.shape):
                continue  # scalar slots (Beta1Pow, ...) update densely
            mask = torch.reshape(touched, (g.height, ) + (1, ) *
                                 (len(shape) - 1))
            ctx.store(n, torch.where(mask, new, old))


def sparsify_optimizer(op_type):
    """Register ``op_type``'s lowering again, wrapped to take a SparseRows
    gradient: its row-subset update where ``_ROW_SUBSET_APPLY`` has one,
    else ``lazy_apply`` over the dense lowering."""
    from . import registry
    dense_fn = registry._LOWERINGS[op_type]
    row_fn = _ROW_SUBSET_APPLY.get(op_type)

    def wrapped(ctx, op):
        g = ctx.get(op, 'Grad')
        if isinstance(g, SparseRows) and row_fn is not None:
            row_fn(ctx, op, g)
            return
        lazy_apply(ctx, op, dense_fn)

    register_lowering(op_type)(wrapped)
