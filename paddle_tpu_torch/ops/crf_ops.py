"""Linear-chain CRF op lowerings (counterpart of ``paddle_tpu/ops/crf_ops.py``):
``linear_chain_crf`` (the negative log-likelihood of the gold path) and
``crf_decoding`` (Viterbi).

The JAX package runs both as a ``lax.scan`` over the padded time axis;
here each is a Python loop over T, the pattern of the ``recurrent``
lowering.  Every step is a fixed-shape device op (a padding step carries
its row through ``torch.where``), so a block that holds them is captured
as one CUDA graph.  ``linear_chain_crf``'s gradient is the generic one
(``torch.func.vjp`` of this forward), as the JAX package takes it from
``jax.vjp``.

Transition layout as in the reference: row 0 the start weights, row 1 the
end weights, rows 2.. the [D, D] transition, w[i, j] the score of moving
from tag i to tag j.
"""

import torch

from .registry import register_lowering, SEQLEN_SUFFIX


def _emission_label_lengths(ctx, op):
    emission = ctx.get(op, 'Emission')  # [B, T, D]
    label = ctx.get(op, 'Label')
    if label is not None and label.dim() == 3:
        label = label[..., 0]  # [B, T]
    lengths = ctx.env.get(op.input('Emission')[0] + SEQLEN_SUFFIX)
    b, t = emission.shape[0], emission.shape[1]
    if lengths is None:
        lengths = torch.full((b, ), t, dtype=torch.int32,
                             device=emission.device)
    return emission, label, lengths


@register_lowering('linear_chain_crf')
def _linear_chain_crf(ctx, op):
    """Negative log-likelihood of the gold path per sequence, [B, 1] (the
    reference's LogLikelihood output is the negated log-likelihood too)."""
    emission, label, lengths = _emission_label_lengths(ctx, op)
    transition = ctx.get(op, 'Transition')  # [D+2, D]
    t = emission.shape[1]
    w_start, w_end, w = transition[0], transition[1], transition[2:]

    # partition function: the alpha recursion in log space
    alpha = w_start[None, :] + emission[:, 0]  # [B, D]
    for i in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + w[None, :, :], dim=1) + \
            emission[:, i]
        alpha = torch.where((i < lengths)[:, None], new, alpha)
    log_z = torch.logsumexp(alpha + w_end[None, :], dim=1)  # [B]

    # the gold path's score, its terms picked by one-hot products: their
    # gradients are products too, with no scatter whose atomics would sum a
    # repeated tag's contributions in another order at every run
    steps = torch.arange(t, device=emission.device)
    valid = steps[None, :] < lengths[:, None]  # [B, T]
    lab = torch.where(valid, label, torch.zeros_like(label)).long()
    hot = torch.nn.functional.one_hot(lab, emission.shape[2]).to(
        emission.dtype) * valid[:, :, None].to(emission.dtype)  # [B, T, D]
    em_sum = torch.sum(emission * hot, dim=(1, 2))
    trans_sum = torch.sum(torch.matmul(hot[:, :-1], w) * hot[:, 1:],
                          dim=(1, 2))
    last = torch.clamp_min(lengths.long() - 1, 0)
    last_hot = hot[torch.arange(hot.shape[0], device=hot.device), last]
    score = em_sum + trans_sum + hot[:, 0] @ w_start + last_hot @ w_end
    ctx.set(op, 'LogLikelihood', (log_z - score)[:, None])


@register_lowering('crf_decoding')
def _crf_decoding(ctx, op):
    """Viterbi decode (reference crf_decoding_op.h Decode): a forward max
    recursion keeping back-pointers, then a backtrack from each row's own
    last step.  With a Label input the output is the per-token correctness
    indicator, as in the reference."""
    emission, label, lengths = _emission_label_lengths(ctx, op)
    transition = ctx.get(op, 'Transition')
    b, t, _ = emission.shape
    w_start, w_end, w = transition[0], transition[1], transition[2:]

    v = w_start[None, :] + emission[:, 0]
    ptrs = []  # ptrs[k]: the back-pointers into step k + 1, [B, D]
    for i in range(1, t):
        scores = v[:, :, None] + w[None, :, :]  # [B, D(from), D(to)]
        ptrs.append(torch.argmax(scores, dim=1))
        best = torch.amax(scores, dim=1) + emission[:, i]
        v = torch.where((i < lengths)[:, None], best, v)
    # a padding step carries v through, so v is each row's v at L - 1
    last_state = torch.argmax(v + w_end[None, :], dim=1)  # [B]

    last_step = lengths.long() - 1
    zero = torch.zeros_like(last_state)
    state = last_state
    path = [None] * t
    for i in reversed(range(t)):
        prev = zero if i == t - 1 else \
            torch.gather(ptrs[i], 1, state[:, None])[:, 0]
        s = torch.where(last_step == i, last_state,
                        torch.where(last_step > i, prev, zero))
        # the carry holds the state at i for the next (earlier) step
        state = torch.where(last_step >= i, s, last_state)
        path[i] = s
    path = torch.stack(path, dim=1)  # [B, T]
    valid = torch.arange(t, device=emission.device)[None, :] < \
        lengths[:, None]
    path = torch.where(valid, path, torch.zeros_like(path)).long()
    if label is not None:
        path = ((path == label.long()) & valid).long()
    name = op.output('ViterbiPath')[0]
    ctx.store(name, path[:, :, None])
    ctx.store(name + SEQLEN_SUFFIX, lengths)
