"""Control-flow op lowerings (counterpart of
``paddle_tpu/ops/control_flow_ops.py``): ``recurrent`` (``StaticRNN`` and
``DynamicRNN``), ``while``, ``conditional_block``, ``ifelse``,
``switch_case``, ``split_lod_tensor`` / ``merge_lod_tensor`` and the
tensor-array ops.

The JAX package lowers a sub-block once into a ``lax.scan`` or
``lax.while_loop``; here a loop is a Python loop that runs the sub-block's
ops through ``registry.run_op`` at every step, in a context whose block is
the sub-block:

- ``recurrent`` loops over T.  It is a plain function of tensors (no
  in-place write to the carry or to a closure tensor, no ``.item()``), so
  ``recurrent_grad`` is the registry's generic ``torch.func.vjp`` of this
  lowering: it replays the whole loop and keeps every step's intermediates,
  where the JAX package rematerializes them (``jax.checkpoint``).
- ``while`` without ``max_trip_count`` has a data-dependent trip count: it
  reads its condition on the host at every trip, so it is declared
  uncapturable and its block runs eagerly.  With ``max_trip_count`` it runs
  the bound's trips, each carried var blended with ``torch.where`` once the
  condition is false (the JAX package's ``_while_scan``): capturable, and
  differentiable through the generic grad.
- ``conditional_block``, ``ifelse`` and ``switch_case`` run every branch
  and select, so a branch may hold no host op.

A tensor array is a Python list of tensors while its indices are known on
the host (``ctx.concrete``: ``fill_constant`` and ``increment`` chains), and
a stacked tensor once an index is a device value (inside a bounded loop,
whose carried arrays are preallocated to len + bound).  A device index
reads with a clamped ``index_select`` and writes by a one-hot blend, which
drops an index past the end as XLA drops it: nothing reads an index on the
host.
"""

import torch

from .registry import (register_lowering, register_grad_lowering,
                       declare_uncapturable, is_host_op_type,
                       LoweringContext, run_op, fwd_structure, GRAD_SUFFIX,
                       SEQLEN_SUFFIX)


def _block_reads_writes(block):
    """Every name the block's ops read, and every name they write, each in
    first-use order."""
    reads, writes = [], []
    for op in block.ops:
        for n in op.input_arg_names:
            if n not in reads:
                reads.append(n)
        for n in op.output_arg_names:
            if n not in writes:
                writes.append(n)
    return reads, writes


def _run_block(ctx, block, env, concrete=None):
    """Run ``block``'s ops over ``env``; a step draws no randomness.  The
    body runs conditionally: its reads are not checked for conditionally
    uninitialized vars and its writes do not cover them.  Returns the
    body's context."""
    sub = LoweringContext(block, env, ctx.place, is_test=ctx.is_test,
                          cond_uninit=ctx.cond_uninit,
                          conditional_scope=True)
    if concrete:
        sub.concrete.update(concrete)
    for op in block.ops:
        run_op(sub, op)
    return sub


def _reject_host_ops(block, where):
    """Blended control flow runs every branch and selects: a host op (its
    side effect would run whatever the condition) is refused."""
    for op in block.ops:
        if is_host_op_type(op.type):
            raise RuntimeError(
                '%s: branch contains host op %r; all branches of blended '
                'control flow execute, so side-effecting ops are invalid '
                'inside them — hoist it out of the branch' % (where, op.type))


def _scalar_bool(t):
    return torch.reshape(t, ()).bool()


def _rows(mask, ndim):
    """A [B] step mask shaped to broadcast over a [B, ...] value."""
    return torch.reshape(mask, (mask.shape[0], ) + (1, ) * (ndim - 1))


@register_lowering('recurrent')
def _recurrent(ctx, op):
    """StaticRNN / DynamicRNN: one loop over the time axis.

    Sequence inputs arrive padded [B, T, ...] ([T, B, ...] with
    ``time_major``); memories carry across steps; with ``masked`` a row's
    memories advance only while t < its length and its outputs past the
    length are zero (where the reference shrinks the batch)."""
    block = op.attrs['sub_block']
    seq_names = op.input('SeqInputs')
    step_names = op.attrs['step_input_names']
    mem_names = op.attrs['mem_names']
    mem_update_names = op.attrs['mem_update_names']
    mem_init_names = op.input('MemInits')
    out_names = op.attrs['output_names']
    masked = op.attrs.get('masked', False)
    time_major = op.attrs.get('time_major', False)

    seqs = [ctx.lookup(n) for n in seq_names]
    if time_major:
        t, b = seqs[0].shape[0], seqs[0].shape[1]
        xs = list(seqs)
    else:
        t, b = seqs[0].shape[1], seqs[0].shape[0]
        xs = [torch.transpose(s, 0, 1) for s in seqs]  # [T, B, ...]

    lengths = None
    if masked:
        for n in seq_names:
            if (n + SEQLEN_SUFFIX) in ctx.env:
                lengths = ctx.env[n + SEQLEN_SUFFIX]
                break
    device = seqs[0].device
    if lengths is not None:
        step_mask = (torch.arange(t, device=device)[None, :] <
                     lengths[:, None]).t()  # [T, B] bool
    else:
        step_mask = torch.ones((t, b), dtype=torch.bool, device=device)

    # closure: what the step reads from outside, with the lengths of the
    # sequences among it (the attention's sequence ops need them); the
    # step's own slices and memories carry no lengths
    closure = {}
    for n in _block_reads_writes(block)[0]:
        if n in step_names or n in mem_names:
            continue
        if ctx.has(n):
            closure[n] = ctx.lookup(n)
        key = n + SEQLEN_SUFFIX
        if key in ctx.env:
            closure[key] = ctx.env[key]

    carry = {m: ctx.lookup(init)
             for m, init in zip(mem_names, mem_init_names)}
    collected = [[] for _ in out_names]
    for i in range(t):
        env = dict(closure)
        env.update({sn: x[i] for sn, x in zip(step_names, xs)})
        env.update(carry)
        _run_block(ctx, block, env)
        m_t = step_mask[i]
        new_carry = {}
        for m, upd in zip(mem_names, mem_update_names):
            new_val = env[upd] if upd is not None else env[m]
            old_val = carry[m]
            # the carry keeps its own dtype (in-step math may promote); the
            # boolean select keeps integer memories (beam ids) exact
            new_carry[m] = torch.where(_rows(m_t, new_val.dim()),
                                       new_val.to(old_val.dtype), old_val)
        carry = new_carry
        for j, on in enumerate(out_names):
            o = env[on]
            collected[j].append(torch.where(_rows(m_t, o.dim()), o,
                                            torch.zeros_like(o)))
    for out_var_name, col in zip(op.output('Out'), collected):
        out = torch.stack(col)
        ctx.store(out_var_name, out if time_major else
                  torch.transpose(out, 0, 1))
        if lengths is not None:
            ctx.env[out_var_name + SEQLEN_SUFFIX] = lengths


# ---- while ----
def _unbounded(op):
    return not int(op.attrs.get('max_trip_count', 0) or 0)


declare_uncapturable('while', 'reads its condition on the host at every '
                     'trip (no max_trip_count)', when=_unbounded)


@register_lowering('while')
def _while(ctx, op):
    """while (cond) { sub-block }.  The 'Init' inputs (aligned with the
    ``carry_names`` attr) are the carried vars' pre-loop snapshots, so that
    a replay of this op by its grad starts from the initial values.

    Unbounded: a host loop that reads the condition at every trip; the
    carried vars' host values (``ctx.concrete``) go on from trip to trip, so
    a tensor array indexed by the loop's counter stays a growable list.
    Bounded (``max_trip_count``): ``_while_bounded``."""
    block = op.attrs['sub_block']
    cond_name = op.input('Condition')[0]
    reads, writes = _block_reads_writes(block)
    attr_carry = op.attrs.get('carry_names')
    init_names = op.input('Init') or []
    if attr_carry:
        carry_names = list(attr_carry)
        snapshot = dict(zip(attr_carry, init_names))
    else:
        carry_names = [cond_name] + [n for n in writes
                                     if ctx.has(n) and n != cond_name]
        snapshot = {}
    closure = {n: ctx.lookup(n) for n in reads
               if ctx.has(n) and n not in carry_names}

    def init_val(n):
        s = snapshot.get(n)
        return ctx.lookup(s) if s is not None and ctx.has(s) \
            else ctx.lookup(n)

    def init_concrete(n):
        s = snapshot.get(n)
        v = ctx.concrete.get(s) if s is not None else None
        return v if v is not None else ctx.concrete.get(n)

    max_trip = int(op.attrs.get('max_trip_count', 0) or 0)
    if max_trip > 0:
        _while_bounded(ctx, block, closure, carry_names, cond_name,
                       init_val, max_trip)
        return
    carry = {n: init_val(n) for n in carry_names}
    known = {n: init_concrete(n) for n in carry_names}
    known = {n: v for n, v in known.items() if v is not None}
    while bool(_scalar_bool(carry[cond_name])):  # the host reads it
        env = dict(closure)
        env.update(carry)
        body = _run_block(ctx, block, env, known)
        carry = {n: env[n] for n in carry_names}
        known = {n: body.concrete[n] for n in carry_names
                 if n in body.concrete}
    for n, v in carry.items():
        ctx.store(n, v)
    ctx.concrete.update(known)


def _while_bounded(ctx, block, closure, carry_names, cond_name, init_val,
                   max_trip):
    """The bounded while: ``max_trip`` trips of the body, each carried var
    kept at its old value once the condition is false, so that the trips
    past the exit change nothing.  A carried tensor array is stacked and
    padded by the bound, so that device-indexed writes land."""
    carry = {}
    for n in carry_names:
        v = init_val(n)
        if isinstance(v, list):
            if not v:
                raise RuntimeError(
                    'while(max_trip_count): carried tensor array %r is '
                    'empty at loop entry; write its first element before '
                    'the loop so the element shape is known' % n)
            v = torch.stack(list(v) + [torch.zeros_like(v[0])] * max_trip)
        carry[n] = v
    for _ in range(max_trip):
        alive = _scalar_bool(carry[cond_name])
        env = dict(closure)
        env.update(carry)
        _run_block(ctx, block, env)
        new_carry = {}
        for n in carry_names:
            new, old = env[n], carry[n]
            if isinstance(new, list):  # the body rebuilt an array
                new = torch.stack(new)
            if new.shape != old.shape:
                raise RuntimeError(
                    'while(max_trip_count): carried var %r changed shape '
                    '%s -> %s inside the body; bounded loops need '
                    'fixed-shape carries' % (n, tuple(old.shape),
                                             tuple(new.shape)))
            new_carry[n] = torch.where(alive, new.to(old.dtype), old)
        carry = new_carry
    for n, v in carry.items():
        ctx.store(n, v)


# ---- blended branches ----
@register_lowering('switch_case')
def _switch_case(ctx, op):
    """Every case block runs; each written var takes the first true case's
    value, the default case's where none is true."""
    case_conds = op.attrs['case_conds']
    case_blocks = op.attrs['case_blocks']
    for blk in case_blocks:
        _reject_host_ops(blk, 'switch_case')
    written = op.output('Out')
    results = []
    for blk in case_blocks:
        env = dict(ctx.env)
        _run_block(ctx, blk, env)
        results.append({n: env[n] for n in written if n in env})
    for n in written:
        val = None
        for cond_name, res in zip(reversed(case_conds), reversed(results)):
            if n not in res:
                continue
            if val is None or cond_name is None:
                val = res[n]
            else:
                val = torch.where(_scalar_bool(ctx.lookup(cond_name)),
                                  res[n], val)
        if val is not None:
            ctx.store(n, val)


def _split_compact(x, mask_rows):
    """The rows where ``mask_rows``, moved to the front in their order (the
    static-shape split: the tail holds the other rows, which merge never
    reads)."""
    order = torch.argsort(torch.logical_not(mask_rows).to(torch.int32),
                          stable=True)
    return torch.index_select(x, 0, order)


def _take_clamped(x, idx):
    return torch.index_select(x, 0, torch.clamp(idx, 0, x.shape[0] - 1))


@register_lowering('split_lod_tensor')
def _split_lod_tensor(ctx, op):
    """Both outputs keep X's row count, their rows compacted to the front;
    each one's real row count rides beside it as ``<name>@ROWCOUNT``."""
    x = ctx.get(op, 'X')
    m = torch.reshape(ctx.get(op, 'Mask'), (-1, )).bool()
    ctx.set(op, 'OutTrue', _split_compact(x, m))
    ctx.set(op, 'OutFalse', _split_compact(x, torch.logical_not(m)))
    n_true = torch.sum(m.to(torch.int32))
    for slot, n in (('OutTrue', n_true), ('OutFalse', x.shape[0] - n_true)):
        names = op.output(slot)
        if names:
            ctx.env[names[0] + '@ROWCOUNT'] = n


def _merge_index(m):
    """Each row's position among the compacted true rows and among the
    false rows."""
    ti = torch.cumsum(m.to(torch.int32), 0) - 1
    fi = torch.cumsum(torch.logical_not(m).to(torch.int32), 0) - 1
    return ti, fi


def _rows_mask(m, ndim):
    return torch.reshape(m, (m.shape[0], ) + (1, ) * (ndim - 1))


@register_lowering('merge_lod_tensor')
def _merge_lod_tensor(ctx, op):
    """The inverse of split_lod_tensor: row r is the next compacted row of
    InTrue where the mask holds, else of InFalse."""
    m = torch.reshape(ctx.get(op, 'Mask'), (-1, )).bool()
    ti, fi = _merge_index(m)
    tv = _take_clamped(ctx.get(op, 'InTrue'), ti)
    fv = _take_clamped(ctx.get(op, 'InFalse'), fi)
    ctx.set(op, 'Out', torch.where(_rows_mask(m, tv.dim()), tv, fv))


@register_lowering('ifelse')
def _ifelse(ctx, op):
    """Routed (a branch read its rows through split_lod_tensor): its
    outputs are re-expanded as merge_lod_tensor does.  Unrouted: both
    branches run on the whole batch, and a cond with the outputs' leading
    dim selects rows, a one-element cond whole tensors."""
    cond = ctx.get(op, 'Cond')
    true_block = op.attrs['true_block']
    false_block = op.attrs['false_block']
    routed_true = op.attrs.get('routed_true', op.attrs.get('routed', False))
    routed_false = op.attrs.get('routed_false',
                                op.attrs.get('routed', False))
    for blk in (true_block, false_block):
        if blk is not None:
            _reject_host_ops(blk, 'ifelse')
    env_t, env_f = dict(ctx.env), dict(ctx.env)
    if true_block is not None:
        _run_block(ctx, true_block, env_t)
    if false_block is not None:
        _run_block(ctx, false_block, env_f)
    c = torch.reshape(cond, (-1, ))
    m = c.bool()
    ti, fi = _merge_index(m)
    for out_name, tn, fn_ in zip(op.output('Out'), op.attrs['true_out'],
                                 op.attrs['false_out']):
        tv, fv = env_t[tn], env_f[fn_]
        rowwise = tv.dim() >= 1 and tv.shape[0] == c.shape[0]
        if (routed_true or routed_false) and rowwise:
            tvr = _take_clamped(tv, ti) if routed_true else tv
            fvr = _take_clamped(fv, fi) if routed_false else fv
            ctx.store(out_name, torch.where(_rows_mask(m, tv.dim()), tvr,
                                            fvr))
            continue
        if tv.dim() > 1 and c.shape[0] == tv.shape[0] and c.shape[0] > 1:
            cc = _rows_mask(m, tv.dim())
        elif cond.numel() == 1:
            cc = _scalar_bool(cond)
        else:
            cc = _rows_mask(m, tv.dim())
        ctx.store(out_name, torch.where(cc, tv, fv))


@register_lowering('conditional_block')
def _conditional_block(ctx, op):
    """The sub-block runs, and each var it writes keeps its old value where
    the cond is false.  A var first assigned here gets zeros there, and
    until an unconditional write or a second branch covers it, a read of it
    is rejected (``registry.check_cond_uninit``), as the reference errors
    on reading an uninitialized var."""
    conds = [ctx.env[n] for n in (op.input('X') or op.input('Cond'))]
    block = op.attrs['sub_block']
    _reject_host_ops(block, 'conditional_block')
    c = _scalar_bool(conds[0])
    env = dict(ctx.env)
    _run_block(ctx, block, env)
    for n in _block_reads_writes(block)[1]:
        if n in block.vars:
            continue  # a temp of the block
        new = env[n]
        if ctx.has(n):
            old = ctx.lookup(n)
            # a second conditional write covers the name (the IfElse
            # pattern of two complementary branches)
            ctx.cond_uninit.discard(n)
        else:
            old = torch.zeros_like(new)
            ctx.cond_uninit.add(n)
        ctx.store(n, torch.where(c, new, old))


# ---- tensor arrays ----
def _known_index(ctx, op):
    """The I input's value when it is known on the host, else None."""
    idx = ctx.concrete.get(op.input('I')[0])
    return None if idx is None else int(idx)


def _device_index(i):
    return torch.reshape(i, ()).long()


def _one_hot_rows(i, n, ndim, device):
    """[n, 1, ...] bool: row i (none when i is past the end)."""
    hit = torch.arange(n, device=device) == i
    return torch.reshape(hit, (n, ) + (1, ) * (ndim - 1))


def _stacked(arr):
    return torch.stack(arr) if isinstance(arr, list) else arr


def _read_row(arr, i):
    """Row ``i`` (a device index) of a stacked array, clamped into range as
    a gather clamps."""
    return torch.index_select(
        arr, 0, torch.clamp(torch.reshape(i, (1, )).long(), 0,
                            arr.shape[0] - 1))[0]


@register_lowering('write_to_array')
def _write_to_array(ctx, op):
    """A known index keeps the array a list, grown as needed.  A device
    index needs a stacked array (preallocated by a bounded while) or a
    non-empty list, and writes row i by a blend: an index past the end is
    dropped."""
    x = ctx.get(op, 'X')
    name = op.output('Out')[0]
    prev = ctx.env.get(name)
    idx = _known_index(ctx, op)
    op_id = op.attrs.get('_array_op_id')
    if op_id is not None:
        ctx.array_log[op_id] = idx
    if idx is not None:
        lst = (list(prev) if isinstance(prev, list) else
               [] if prev is None else list(prev.unbind(0)))
        while len(lst) <= idx:
            lst.append(torch.zeros_like(x))
        lst[idx] = x
        ctx.store(name, lst)
        return
    if prev is None or (isinstance(prev, list) and not prev):
        raise RuntimeError(
            'write_to_array %r: traced index into an empty tensor array — '
            'preallocate it (while max_trip_count mode does) or write a '
            'first element with a concrete index before the loop' % name)
    stacked = _stacked(prev)
    hit = _one_hot_rows(_device_index(ctx.get(op, 'I')), stacked.shape[0],
                        stacked.dim(), stacked.device)
    ctx.store(name, torch.where(hit, x.to(stacked.dtype)[None], stacked))


@register_grad_lowering('write_to_array')
def _write_to_array_grad(ctx, op):
    """X's gradient is the array gradient's row at the write's index (its
    forward index, from ``ctx.array_log``: the index var may have been
    incremented in place since), and that row is zeroed before the earlier
    writes' grads read it."""
    fwd_inputs, fwd_outputs, fwd_attrs = fwd_structure(op)
    arr_gname = fwd_outputs['Out'][0] + GRAD_SUFFIX
    if not ctx.has(arr_gname):
        return
    logged = ctx.array_log.get(fwd_attrs.get('_array_op_id'))
    g = ctx.lookup(arr_gname)
    if isinstance(g, list) and logged is not None:
        if logged < len(g):
            xg = g[logged]
            rest = list(g)
            rest[logged] = torch.zeros_like(xg)
        else:  # the cotangent never reached this slot
            xg = torch.zeros_like(ctx.lookup(fwd_inputs['X'][0]))
            rest = g
    else:
        g = _stacked(g)
        i = torch.full((), logged, dtype=torch.long, device=g.device) \
            if logged is not None else \
            _device_index(ctx.lookup(fwd_inputs['I'][0]))
        xg = _read_row(g, i)
        rest = torch.where(_one_hot_rows(i, g.shape[0], g.dim(), g.device),
                           torch.zeros_like(g), g)
    xg_names = op.output('X' + GRAD_SUFFIX)
    if xg_names and xg_names[0]:
        prev = ctx.env.get(xg_names[0])
        ctx.store(xg_names[0], xg if prev is None else prev + xg)
    ctx.store(arr_gname, rest)


@register_lowering('read_from_array')
def _read_from_array(ctx, op):
    arr = ctx.get(op, 'X')
    idx = _known_index(ctx, op) if isinstance(arr, list) else None
    op_id = op.attrs.get('_array_op_id')
    if op_id is not None and isinstance(arr, list):
        ctx.array_log[op_id] = idx
    if idx is not None:
        ctx.set(op, 'Out', arr[idx])
        return
    ctx.set(op, 'Out', _read_row(_stacked(arr), ctx.get(op, 'I')))


@register_grad_lowering('read_from_array')
def _read_from_array_grad(ctx, op):
    """The out-gradient added into the array's gradient at the read's
    index; the array gradient starts as zeros shaped like the array."""
    fwd_inputs, fwd_outputs, fwd_attrs = fwd_structure(op)
    og_name = fwd_outputs['Out'][0] + GRAD_SUFFIX
    gnames = op.output('X' + GRAD_SUFFIX)
    if not ctx.has(og_name) or not gnames or not gnames[0]:
        return
    og = ctx.lookup(og_name)
    gname = gnames[0]
    logged = ctx.array_log.get(fwd_attrs.get('_array_op_id'))
    if ctx.has(gname):
        cur = ctx.lookup(gname)
    else:
        arr = ctx.lookup(fwd_inputs['X'][0])
        cur = ([torch.zeros_like(a) for a in arr] if isinstance(arr, list)
               else torch.zeros_like(arr))
    if isinstance(cur, list) and logged is not None:
        cur = list(cur)
        cur[logged] = cur[logged] + og
        ctx.store(gname, cur)
        return
    cur = _stacked(cur)
    i = torch.full((), logged, dtype=torch.long, device=cur.device) \
        if logged is not None else \
        _device_index(ctx.lookup(fwd_inputs['I'][0]))
    hit = _one_hot_rows(i, cur.shape[0], cur.dim(), cur.device)
    ctx.store(gname, cur + torch.where(hit, og.to(cur.dtype)[None],
                                       torch.zeros_like(cur)))


@register_lowering('lod_array_length')
def _lod_array_length(ctx, op):
    arr = ctx.get(op, 'X')
    n = len(arr) if isinstance(arr, list) else arr.shape[0]
    ctx.set(op, 'Out', torch.full((1, ), n, dtype=torch.int64,
                                  device=ctx.device))


@register_lowering('max_sequence_len')
def _max_sequence_len(ctx, op):
    ctx.set(op, 'Out', torch.full((1, ), ctx.get(op, 'RankTable').shape[0],
                                  dtype=torch.int64, device=ctx.device))
