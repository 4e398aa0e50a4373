"""Sequence op lowerings (counterpart of ``paddle_tpu/ops/sequence_ops.py``:
``sequence_pool`` with its first/last-step aliases, and ``lstm``).

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
from ..fluid import flags


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
