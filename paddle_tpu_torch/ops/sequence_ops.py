"""Sequence op lowerings (counterpart of ``paddle_tpu/ops/sequence_ops.py``:
``sequence_pool`` with its first/last-step aliases, ``sequence_softmax``,
``sequence_expand``, ``sequence_conv``, ``sequence_mask``, ``lstm``,
``gru`` and ``gru_unit``).

A LoD feed runs as a padded ``[B, T, ...]`` tensor with its int32 lengths
carried beside it under ``<name>@SEQLEN`` (``registry.run_op`` propagates
them); every sequence op here is a masked dense op on that form.

``lstm`` has two paths, as in the JAX package:

- the scan path, a Python loop over T with peepholes, any of the four
  activations, and ``is_reverse`` as flips of the time axis;
- the kernel path, ``ops/kernels/lstm.py`` (the hand-written Hopper kernels
  on a CUDA place, their plain version on the CPU), for an op that
  ``_fused_lstm_ok`` finds eligible under ``FLAGS_fused_lstm``.
"""

import torch

from .registry import register_lowering, SEQLEN_SUFFIX
from .kernels import lstm as lstm_kernels
from ..fluid import core, flags


def _seqlen(ctx, op, slot='X'):
    names = op.input(slot)
    if not names:
        return None
    return ctx.env.get(names[0] + SEQLEN_SUFFIX)


def _fused_lstm_ok(device, d, b_sz, dtype, use_peepholes, gate_act_name,
                   cell_act_name, cand_act_name):
    """Whether an ``lstm`` op runs the kernel path.

    An op is eligible when it has no peepholes, the default activations
    (sigmoid gates, tanh cell and candidate) and a width, batch and dtype
    the kernels take (``lstm_kernels.kernel_takes``: D a multiple of 32 in
    [32, 512], any B, float32 or bfloat16); an ineligible op takes the scan
    path in every mode.  For an eligible op, ``FLAGS_fused_lstm``:

    - on a CUDA place, 'auto' and 'always' run the kernels, 'never' the scan
      path.  The JAX package keeps 'auto' on its scan path because on a TPU
      v5e XLA fuses the scan with its neighbours and the kernel's custom
      call blocks that fusion; an eager executor fuses nothing, and its
      scan path is some 15 launches per step of every layer
      (``chip_smoke.py`` times both paths);
    - on the CPU, 'auto' and 'never' run the scan path (as in the JAX
      package) and 'always' the kernels' plain version (where the JAX
      package runs its kernel in interpret mode).
    """
    mode = flags.FLAGS.fused_lstm
    if mode == 'never' or (mode == 'auto' and device.type != 'cuda'):
        return False
    return (not use_peepholes
            and gate_act_name == 'sigmoid'
            and cell_act_name == 'tanh'
            and cand_act_name == 'tanh'
            and lstm_kernels.kernel_takes(d, b_sz, dtype))


def _mask(x, lengths, dtype=None):
    """[B, T] validity mask for x [B, T, ...]."""
    t = x.shape[1]
    m = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    return m if dtype is None else m.to(dtype)


def _expand_mask(m, x):
    return torch.reshape(m, tuple(m.shape) + (1, ) * (x.dim() - 2))


@register_lowering('sequence_pool')
def _sequence_pool(ctx, op):
    x = ctx.get(op, 'X')  # [B, T, ...]
    lengths = _seqlen(ctx, op)
    ptype = op.attrs.get('pooltype', 'AVERAGE').upper()
    if lengths is None:
        lengths = torch.full((x.shape[0], ), x.shape[1], dtype=torch.int32,
                             device=x.device)
    m = _expand_mask(_mask(x, lengths, x.dtype), x)
    lens = torch.clamp_min(lengths, 1).to(x.dtype)
    lens = torch.reshape(lens, (x.shape[0], ) + (1, ) * (x.dim() - 2))
    if ptype == 'SUM':
        out = torch.sum(x * m, dim=1)
    elif ptype == 'AVERAGE':
        out = torch.sum(x * m, dim=1) / lens
    elif ptype == 'SQRT':
        out = torch.sum(x * m, dim=1) / torch.sqrt(lens)
    elif ptype == 'MAX':
        out = torch.amax(torch.where(m > 0, x, float('-inf')), dim=1)
        # a length-0 row pools to zero, not -inf
        out = torch.where(torch.reshape(lengths, lens.shape) > 0, out, 0.0)
    elif ptype == 'LAST':
        idx = torch.clamp_min(lengths - 1, 0).long()
        out = torch.take_along_dim(
            x, torch.reshape(idx, (-1, 1) + (1, ) * (x.dim() - 2)),
            dim=1)[:, 0]
    elif ptype == 'FIRST':
        out = x[:, 0]
    else:
        raise NotImplementedError('sequence_pool type %r' % ptype)
    ctx.set(op, 'Out', out)
    if ptype == 'MAX':
        # the index output is unused, as in the JAX package
        ctx.set(op, 'MaxIndex', torch.zeros(out.shape, dtype=torch.int32,
                                            device=out.device))


@register_lowering('sequence_softmax')
def _sequence_softmax(ctx, op):
    """Softmax over T within each row's length, zeros past it."""
    x = ctx.get(op, 'X')  # [B, T] or [B, T, 1]
    lengths = _seqlen(ctx, op)
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    v = x[..., 0] if squeeze else x
    if lengths is None:
        out = torch.softmax(v, dim=1)
    else:
        m = _mask(v, lengths)
        out = torch.softmax(torch.where(m, v, -1e30), dim=1)
        out = torch.where(m, out, 0.0)
    ctx.set(op, 'Out', out[..., None] if squeeze else out)


@register_lowering('sequence_expand')
def _sequence_expand(ctx, op):
    """Broadcast each batch row of X across its ref sequence Y's steps (the
    level-1 expansion on the padded form); the output carries Y's
    lengths."""
    if op.attrs.get('expand_from_sequence'):
        raise NotImplementedError(
            'sequence_expand(expand_from_sequence=True) expands to a nested '
            '(2-level LoD) ref, which the PyTorch port does not run yet '
            '(ROADMAP.md, Queue 1: the nested-LoD sequence ops)')
    x = ctx.get(op, 'X')  # [B, D]
    y = ctx.get(op, 'Y')  # [B, T, ...]: the target lengths
    if x.dim() == y.dim():  # already per step
        ctx.set(op, 'Out', x)
        return
    out = torch.repeat_interleave(x[:, None], y.shape[1], dim=1)
    ctx.set(op, 'Out', out)
    ynames = op.input('Y')
    if ynames and (ynames[0] + SEQLEN_SUFFIX) in ctx.env:
        for n in op.output('Out'):
            ctx.env[n + SEQLEN_SUFFIX] = ctx.env[ynames[0] + SEQLEN_SUFFIX]


@register_lowering('sequence_conv')
def _sequence_conv(ctx, op):
    """Context-window projection over time (reference
    operators/sequence_conv_op.cc, math/context_project.h): the padded
    steps masked to zero, the time axis padded so that every window is in
    bounds, the ``contextLength`` shifted views concatenated and multiplied
    by Filter."""
    x = ctx.get(op, 'X')  # [B, T, D]
    w = ctx.get(op, 'Filter')  # [ctx_len * D, M]
    lengths = _seqlen(ctx, op)
    ctx_len = op.attrs.get('contextLength', 3)
    ctx_start = op.attrs.get('contextStart', -(ctx_len // 2))
    t = x.shape[1]
    if lengths is not None:
        x = x * _expand_mask(_mask(x, lengths, x.dtype), x)
    pad_lo = max(-ctx_start, 0)
    pad_hi = max(ctx_start + ctx_len - 1, 0)
    xp = torch.nn.functional.pad(x, (0, 0, pad_lo, pad_hi))
    views = [xp[:, pad_lo + ctx_start + i:pad_lo + ctx_start + i + t]
             for i in range(ctx_len)]
    ctx.set(op, 'Out', torch.matmul(torch.cat(views, dim=-1), w))


@register_lowering('sequence_last_step')
def _sequence_last_step(ctx, op):
    op.attrs['pooltype'] = 'LAST'
    _sequence_pool(ctx, op)


@register_lowering('sequence_first_step')
def _sequence_first_step(ctx, op):
    op.attrs['pooltype'] = 'FIRST'
    _sequence_pool(ctx, op)


_ACTS = {
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'relu': torch.relu,
    'identity': lambda v: v,
}


def _act(name):
    return _ACTS[name or 'tanh']


@register_lowering('lstm')
def _lstm(ctx, op):
    """Dynamic LSTM.  Input is the pre-projected gate matrix [B, T, 4D]; the
    op runs h_t = f(x_t + h_{t-1} W + b) with per-step masking of each row
    past its length.  Gate layout [candidate, input, forget, output]; with
    peepholes the bias is [1, 7D], its tail the input, forget and output
    peephole weights."""
    x = ctx.get(op, 'Input')  # [B, T, 4D]
    w = ctx.get(op, 'Weight')  # [D, 4D]
    bias = ctx.get(op, 'Bias')
    h0 = ctx.get(op, 'H0')
    c0 = ctx.get(op, 'C0')
    lengths = _seqlen(ctx, op, 'Input')
    use_peepholes = op.attrs.get('use_peepholes', False)
    is_reverse = op.attrs.get('is_reverse', False)
    gate_name = op.attrs.get('gate_activation', 'sigmoid')
    cell_name = op.attrs.get('cell_activation', 'tanh')
    cand_name = op.attrs.get('candidate_activation', 'tanh')

    b_sz, t, d4 = x.shape
    d = d4 // 4
    gate_bias = bias[:, :4 * d] if bias is not None else 0.0
    # x and the hidden state h stay in x's dtype; gates and the cell state
    # compute and carry in f32
    cd = x.dtype
    h_prev = (h0.to(cd) if h0 is not None else
              torch.zeros((b_sz, d), dtype=cd, device=x.device))
    c_prev = (c0.to(torch.float32) if c0 is not None else
              torch.zeros((b_sz, d), dtype=torch.float32, device=x.device))

    xs = torch.transpose(x, 0, 1)  # [T, B, 4D]
    if is_reverse:
        xs = torch.flip(xs, (0, ))
    if lengths is None:
        step_mask = torch.ones((t, b_sz), dtype=torch.float32,
                               device=x.device)
    else:
        step_mask = _mask(x, lengths, torch.float32).t()  # [T, B]
        if is_reverse:
            step_mask = torch.flip(step_mask, (0, ))

    if _fused_lstm_ok(ctx.device, d, b_sz, cd, use_peepholes, gate_name,
                      cell_name, cand_name):
        bias_arr = (gate_bias if bias is not None else
                    torch.zeros((1, 4 * d), dtype=torch.float32,
                                device=x.device))
        hs, cs = lstm_kernels.lstm_fused_tm(xs, w, bias_arr, h_prev, c_prev,
                                            mask=step_mask)
    else:
        hs, cs = _lstm_scan(xs, w.to(cd), gate_bias, bias, h_prev, c_prev,
                            step_mask, d, use_peepholes, _act(gate_name),
                            _act(cell_name), _act(cand_name))
    if is_reverse:
        hs = torch.flip(hs, (0, ))
        cs = torch.flip(cs, (0, ))
    ctx.set(op, 'Hidden', torch.transpose(hs, 0, 1))
    ctx.set(op, 'Cell', torch.transpose(cs, 0, 1).to(cd))
    ctx.set(op, 'BatchGate', x)
    ctx.set(op, 'BatchCellPreAct', torch.transpose(cs, 0, 1).to(cd))


def _promoted_mm(a, b):
    """``a @ b`` over operands of two dtypes (a bf16 state under AMP, an
    f32 weight) in their promoted dtype, as ``jnp`` promotes them."""
    common = torch.promote_types(a.dtype, b.dtype)
    return a.to(common) @ b.to(common)


# gru_unit's activation attrs: the reference's enum
_GRU_ACTS = {0: 'identity', 1: 'sigmoid', 2: 'tanh', 3: 'relu'}


@register_lowering('gru_unit')
def _gru_unit(ctx, op):
    """One GRU step.  Gate columns [update u, reset r, candidate c]:
    u, r = act_g(x_ur + h_prev W_ur), c = act(x_c + (r h_prev) W_c),
    h = (1 - u) h_prev + u c."""
    x = ctx.get(op, 'Input')  # [B, 3D]
    h_prev = ctx.get(op, 'HiddenPrev')
    w = ctx.get(op, 'Weight')  # [D, 3D]
    bias = ctx.get(op, 'Bias')
    gate_act = _act(_GRU_ACTS[op.attrs.get('gate_activation', 1)])
    cand_act = _act(_GRU_ACTS[op.attrs.get('activation', 2)])
    d = h_prev.shape[1]
    if bias is not None:
        x = x + bias
    g = gate_act(x[:, :2 * d] + _promoted_mm(h_prev, w[:, :2 * d]))
    u, r = torch.split(g, d, dim=1)
    c = cand_act(x[:, 2 * d:] + _promoted_mm(r * h_prev, w[:, 2 * d:]))
    h = (1 - u) * h_prev + u * c
    ctx.set(op, 'Gate', torch.cat([g, c], dim=1))
    ctx.set(op, 'ResetHiddenPrev', r * h_prev)
    ctx.set(op, 'Hidden', h)


@register_lowering('gru')
def _gru(ctx, op):
    """Dynamic GRU over the pre-projected [B, T, 3D] input, weight [D, 3D]
    with columns [update | reset | candidate], from H0 (else zeros); a
    row's steps past its ``@SEQLEN`` keep its hidden frozen.  The AMP
    dtype flow is ``_lstm``'s: x and h in x's dtype for the products, the
    gate math and the bias in f32 inside the step."""
    x = ctx.get(op, 'Input')
    w = ctx.get(op, 'Weight')
    bias = ctx.get(op, 'Bias')
    h0 = ctx.get(op, 'H0')
    lengths = _seqlen(ctx, op, 'Input')
    is_reverse = op.attrs.get('is_reverse', False)
    gate_act = _act(op.attrs.get('gate_activation', 'sigmoid'))
    cand_act = _act(op.attrs.get('activation', 'tanh'))

    b_sz, t, d3 = x.shape
    d = d3 // 3
    cd = x.dtype
    w_g = w[:, :2 * d].to(cd)
    w_c = w[:, 2 * d:].to(cd)
    if bias is not None:
        bias = torch.reshape(bias, (1, -1)).to(torch.float32)
        bias_g, bias_c = bias[:, :2 * d], bias[:, 2 * d:]
    else:
        bias_g = bias_c = 0.0
    h = (h0.to(cd) if h0 is not None else
         torch.zeros((b_sz, d), dtype=cd, device=x.device))
    xs = torch.transpose(x, 0, 1)  # [T, B, 3D]
    if is_reverse:
        xs = torch.flip(xs, (0, ))
    if lengths is None:
        step_mask = torch.ones((t, b_sz), dtype=torch.float32,
                               device=x.device)
    else:
        step_mask = _mask(x, lengths, torch.float32).t()  # [T, B]
        if is_reverse:
            step_mask = torch.flip(step_mask, (0, ))
    hs = []
    for x_t, m_t in zip(xs, step_mask):
        g = gate_act((x_t[:, :2 * d] + h @ w_g).to(torch.float32) + bias_g)
        u, r = torch.split(g, d, dim=1)
        c = cand_act((x_t[:, 2 * d:] + (r.to(cd) * h) @ w_c).to(
            torch.float32) + bias_c)
        hf = h.to(torch.float32)
        h_new = (1 - u) * hf + u * c
        m = m_t[:, None]
        h = (m * h_new + (1 - m) * hf).to(cd)
        hs.append(h)
    hs = torch.stack(hs)
    if is_reverse:
        hs = torch.flip(hs, (0, ))
    out = torch.transpose(hs, 0, 1)
    ctx.set(op, 'Hidden', out)
    ctx.set(op, 'BatchGate', x)
    ctx.set(op, 'BatchResetHiddenPrev', out)
    ctx.set(op, 'BatchHidden', out)


@register_lowering('sequence_mask')
def _sequence_mask(ctx, op):
    """Lengths [B] (any numeric dtype, a float position counter included)
    -> [B, maxlen] mask in ``out_dtype``; ``maxlen`` must be static, as in
    the JAX package."""
    lengths = torch.reshape(ctx.get(op, 'X'), (-1, ))
    maxlen = int(op.attrs.get('maxlen', -1))
    if maxlen <= 0:
        raise NotImplementedError(
            'sequence_mask needs a static maxlen attr (a dynamic maxlen is '
            'a data-dependent shape)')
    m = torch.arange(maxlen, device=lengths.device)[None, :] < \
        lengths[:, None]
    ctx.set(op, 'Out', m.to(core.convert_dtype_to_torch(
        op.attrs.get('out_dtype', 'int64'))))


def _lstm_scan(xs, w_r, gate_bias, bias, h, c, step_mask, d, use_peepholes,
               gate_act, cell_act, cand_act):
    """The recurrence one step at a time: (hs [T, B, D] in x's dtype, cs
    [T, B, D] f32)."""
    cd = xs.dtype
    if use_peepholes and bias is not None:
        w_ic = bias[0, 4 * d:5 * d]
        w_fc = bias[0, 5 * d:6 * d]
        w_oc = bias[0, 6 * d:7 * d]
    hs, cs = [], []
    for x_t, m_t in zip(xs, step_mask):
        gates = (x_t + h @ w_r).to(torch.float32) + gate_bias
        gc, gi, gf, go = torch.split(gates, d, dim=1)
        if use_peepholes:
            gi = gi + c * w_ic
            gf = gf + c * w_fc
        i = gate_act(gi)
        f = gate_act(gf)
        c_new = f * c + i * cand_act(gc)
        if use_peepholes:
            go = go + c_new * w_oc
        o = gate_act(go)
        h_new = o * cell_act(c_new)
        m = m_t[:, None]
        h = (m * h_new + (1 - m) * h.to(torch.float32)).to(cd)
        c = m * c_new + (1 - m) * c
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


@register_lowering('lod_rank_table')
def _lod_rank_table(ctx, op):
    """The rows sorted by length, longest first, ties in row order (the
    reference's LoDRankTable): on the padded layout, the [B] int32 row
    permutation.  Without lengths every row has X's padded length."""
    x = ctx.get(op, 'X')
    lengths = _seqlen(ctx, op)
    if lengths is None:
        lengths = torch.full((x.shape[0], ), x.shape[1] if x.dim() > 1
                             else 1, dtype=torch.int32, device=x.device)
    perm = torch.argsort(-lengths.to(torch.int32), stable=True)
    ctx.set(op, 'Out', perm.to(torch.int32))


@register_lowering('reorder_lod_tensor_by_rank')
def _reorder_lod_tensor_by_rank(ctx, op):
    """X's rows gathered by a rank table's permutation, its lengths
    permuted with them."""
    perm = ctx.get(op, 'RankTable').long()
    ctx.set(op, 'Out', torch.index_select(ctx.get(op, 'X'), 0, perm))
    lengths = _seqlen(ctx, op)
    if lengths is not None:
        ctx.env[op.output('Out')[0] + SEQLEN_SUFFIX] = torch.index_select(
            lengths, 0, perm)
