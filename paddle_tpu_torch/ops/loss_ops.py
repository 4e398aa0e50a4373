"""Loss op lowerings (counterpart of ``paddle_tpu/ops/loss_ops.py``:
``softmax_with_cross_entropy`` with hard labels, computed in f32)."""

import torch

from .registry import register_lowering, amp_upcast_f32


@register_lowering('softmax_with_cross_entropy')
def _softmax_with_cross_entropy(ctx, op):
    if op.attrs.get('soft_label', False):
        raise NotImplementedError('softmax_with_cross_entropy with '
                                  'soft_label=True is not ported yet')
    logits = amp_upcast_f32(ctx.get(op, 'Logits'))
    label = ctx.get(op, 'Label')
    # (N..., 1) or (N...,) int labels -> (N...,)
    if label.dim() > 1 and label.shape[-1] == 1:
        label = torch.reshape(label, label.shape[:-1])
    idx = label.long()
    ignore = op.attrs.get('ignore_index', -100)
    valid = idx != ignore
    log_p = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(log_p, -1, torch.where(valid, idx, 0)[..., None])
    ctx.set(op, 'Softmax', torch.exp(log_p))
    ctx.set(op, 'Loss', torch.where(valid[..., None], -picked, 0.0))
