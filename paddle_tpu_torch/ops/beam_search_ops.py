"""Beam-search decoding op lowerings (counterpart of
``paddle_tpu/ops/beam_search_ops.py``) on the static beam layout: every beam
tensor has leading dim ``B*K`` (batch x beam, sentence-major), and a dead
beam is a -1e9 score instead of an absent row.  ``beam_search_decode`` walks
the parent pointers back from the last step.

The selection pools of a nested (two-level) LoD, ``beam_search``'s
``row_offsets`` and ``level != 0``, are not ported (``ROADMAP.md``).

Ids and parent rows are int64 here; the JAX package, which runs with x64
off, holds them as int32.
"""

import torch

from .registry import register_lowering, SEQLEN_SUFFIX

NEG_INF = -1e9


@register_lowering('beam_expand')
def _beam_expand(ctx, op):
    """Tile a per-sentence tensor to per-beam rows: [B, ...] -> [B*K, ...],
    its lengths too."""
    x = ctx.get(op, 'X')
    k = int(op.attrs['beam_size'])
    name = op.output('Out')[0]
    ctx.store(name, torch.repeat_interleave(x, k, dim=0))
    seq = ctx.env.get(op.input('X')[0] + SEQLEN_SUFFIX)
    if seq is not None:
        ctx.env[name + SEQLEN_SUFFIX] = torch.repeat_interleave(seq, k, dim=0)


@register_lowering('beam_init_scores')
def _beam_init_scores(ctx, op):
    """Initial accumulated log-probs [B*K, 1]: 0 for beam 0 of each
    sentence, -1e9 for the rest, so that the first step's top-k picks K
    distinct continuations of the one start token."""
    b = ctx.get(op, 'X').shape[0]
    k = int(op.attrs['beam_size'])
    # made on the device (a CUDA graph capture holds no host copy)
    row = torch.where(torch.arange(k, device=ctx.device) == 0, 0.0,
                      NEG_INF).to(torch.float32)
    ctx.set(op, 'Out', row.repeat(b)[:, None])


@register_lowering('beam_search')
def _beam_search(ctx, op):
    """One beam-search selection step.

    Inputs (leading dim B*K, sentence-major): pre_ids [B*K, 1], pre_scores
    [B*K, 1], ids [B*K, C] candidate tokens, scores [B*K, C] their
    accumulated log-probs.  Outputs: selected_ids and selected_scores
    [B*K, 1], parent_idx [B*K], the global row of each survivor's parent.
    A finished beam (pre_id == end_id) offers one candidate, itself with
    its score unchanged."""
    if op.attrs.get('row_offsets') is not None or \
            int(op.attrs.get('level', 0)) != 0:
        raise NotImplementedError(
            'beam_search over nested-LoD selection pools (row_offsets or '
            'level != 0) is not ported to PyTorch yet (ROADMAP.md, Queue 1: '
            'the nested-LoD sequence ops)')
    pre_ids = ctx.get(op, 'pre_ids')
    pre_scores = ctx.get(op, 'pre_scores')
    ids = ctx.get(op, 'ids')
    scores = ctx.get(op, 'scores')
    k = int(op.attrs['beam_size'])
    end_id = int(op.attrs['end_id'])
    bk, c = scores.shape
    b = bk // k
    finished = (torch.reshape(pre_ids, (bk, )) == end_id)[:, None]
    # a finished beam: candidate 0 is (end_id, pre_score), the rest -1e9
    first = torch.arange(c, device=scores.device)[None, :] == 0
    carried = torch.where(first, torch.reshape(pre_scores, (bk, 1)),
                          NEG_INF).to(scores.dtype)
    cand_scores = torch.where(finished, carried, scores)
    cand_ids = torch.where(finished, end_id, ids)
    top_scores, top_idx = torch.topk(torch.reshape(cand_scores, (b, k * c)),
                                     k, dim=1)
    parent_idx = (torch.arange(b, device=scores.device)[:, None] * k +
                  torch.div(top_idx, c, rounding_mode='floor'))
    sel_ids = torch.take_along_dim(torch.reshape(cand_ids, (b, k * c)),
                                   top_idx, dim=1)
    ctx.set(op, 'selected_ids', torch.reshape(sel_ids, (bk, 1)))
    ctx.set(op, 'selected_scores', torch.reshape(top_scores, (bk, 1)))
    ctx.set(op, 'parent_idx', torch.reshape(parent_idx, (bk, )))


@register_lowering('beam_search_decode')
def _beam_search_decode(ctx, op):
    """Backtrack the stacked steps into sentences.

    Inputs: Ids [T, B*K, 1], ParentIdx [T, B*K], Scores [T, B*K, 1], the
    stacked outputs of ``beam_search``.  Outputs: SentenceIds [B, K, T] and
    SentenceScores [B, K], the last step's scores."""
    ids = ctx.get(op, 'Ids')
    parents = ctx.get(op, 'ParentIdx')
    scores = ctx.get(op, 'Scores')
    k = int(op.attrs['beam_size'])
    t, bk = ids.shape[0], ids.shape[1]
    b = bk // k
    ids2 = torch.reshape(ids, (t, bk))
    parents2 = torch.reshape(parents, (t, bk)).long()
    rows = torch.arange(bk, device=ids.device)
    toks = []
    for step in range(t - 1, -1, -1):
        toks.append(ids2[step][rows])
        rows = parents2[step][rows]
    sent = torch.reshape(torch.stack(toks[::-1]).t(), (b, k, t))
    ctx.set(op, 'SentenceIds', sent)
    ctx.set(op, 'SentenceScores',
            torch.reshape(torch.reshape(scores, (t, bk))[-1], (b, k)))
