"""Loss op lowerings (counterpart of ``paddle_tpu/ops/loss_ops.py``:
``cross_entropy`` with hard or soft labels, ``softmax_with_cross_entropy``
with hard labels, and ``sigmoid_cross_entropy_with_logits``, computed in
f32)."""

import torch

from .registry import register_lowering, amp_upcast_f32

_EPS = 1e-12


def _index_label(label):
    """(N..., 1) or (N...,) int labels -> (N...,) int64."""
    if label.dim() > 1 and label.shape[-1] == 1:
        label = torch.reshape(label, label.shape[:-1])
    return label.long()


@register_lowering('cross_entropy')
def _cross_entropy(ctx, op):
    x = amp_upcast_f32(ctx.get(op, 'X'))  # probabilities [N..., C]
    label = ctx.get(op, 'Label')
    if op.attrs.get('soft_label', False):
        loss = -torch.sum(label * torch.log(torch.clamp_min(x, _EPS)),
                          dim=-1, keepdim=True)
    else:
        idx = _index_label(label)
        ignore = op.attrs.get('ignore_index', -100)
        valid = (idx != ignore)[..., None]
        picked = torch.gather(x, -1, torch.where(valid[..., 0], idx, 0)[...,
                                                                        None])
        loss = torch.where(valid, -torch.log(torch.clamp_min(picked, _EPS)),
                           0.0)
    ctx.set(op, 'Y', loss)


@register_lowering('softmax_with_cross_entropy')
def _softmax_with_cross_entropy(ctx, op):
    if op.attrs.get('soft_label', False):
        raise NotImplementedError('softmax_with_cross_entropy with '
                                  'soft_label=True is not ported yet')
    logits = amp_upcast_f32(ctx.get(op, 'Logits'))
    label = ctx.get(op, 'Label')
    idx = _index_label(label)
    ignore = op.attrs.get('ignore_index', -100)
    valid = idx != ignore
    log_p = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(log_p, -1, torch.where(valid, idx, 0)[..., None])
    ctx.set(op, 'Softmax', torch.exp(log_p))
    ctx.set(op, 'Loss', torch.where(valid[..., None], -picked, 0.0))


@register_lowering('sigmoid_cross_entropy_with_logits')
def _sigmoid_cross_entropy_with_logits(ctx, op):
    x = amp_upcast_f32(ctx.get(op, 'X'))
    label = ctx.get(op, 'Label')
    # max(x, 0) - x z + log(1 + exp(-|x|)): no exp of a large positive value
    loss = torch.clamp_min(x, 0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))
    ctx.set(op, 'Out', loss)
