"""Attention references (counterpart of
``paddle_tpu/parallel/context_parallel.py``).  Ring and Ulysses attention
(the 'sp' mesh axis) are not ported yet and raise (``parallel``; ROADMAP.md,
Queue 1 item 7); this holds the single-device dense path.  Layout: [batch, seq, heads, head_dim]."""

import torch

__all__ = ['dense_attention']

_NEG_INF = -1e30


def _block_mask(q_pos, k_pos, causal, batch_lens):
    """[B,1,Lq,Lk] boolean mask (True = attend) from global positions, or
    None.  batch_lens: [B] valid K lengths or None."""
    mask = None
    if causal:
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
    if batch_lens is not None:
        valid = (k_pos[None, :] < batch_lens[:, None])[:, None, None, :]
        mask = valid if mask is None else mask & valid
    if mask is not None:
        mask = mask.expand(mask.shape[0], 1, q_pos.shape[0], k_pos.shape[0])
    return mask


def dense_attention(q, k, v, causal=False, scale=None, seq_lengths=None):
    """Single-device reference: softmax(QK^T * scale [+mask]) V.
    q,k,v: [B,L,H,D]; seq_lengths: [B] optional valid K/V lengths.
    One-shot softmax in f32; all-masked rows give 0."""
    scale = scale if scale is not None else q.shape[-1]**-0.5
    lq, lk = q.shape[1], k.shape[1]
    lens = None if seq_lengths is None else torch.as_tensor(
        seq_lengths).reshape(-1).to(q.device)
    mask = _block_mask(torch.arange(lq, device=q.device),
                       torch.arange(lk, device=q.device), causal, lens)
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = torch.where(mask, p, 0.0)  # all-masked rows: 0, not 1/Lk
    return torch.einsum('bhqk,bkhd->bqhd', p.to(v.dtype), v)
