"""Metric op lowerings (counterpart of ``paddle_tpu/ops/metric_ops.py``:
``accuracy``).  No gradient: ``backward.append_backward`` reaches no metric
op from a loss."""

import torch

from .registry import register_lowering


@register_lowering('accuracy')
def _accuracy(ctx, op):
    indices = ctx.get(op, 'Indices')  # [N, k] from top_k
    label = ctx.get(op, 'Label')  # [N, 1] int64
    if label.dim() == 1:
        label = label[:, None]
    hit = torch.any(indices == label.to(indices.dtype), dim=1)
    correct = torch.sum(hit.to(torch.int64))
    # a fill on the device, not a copy from the host: a capture holds it
    total = torch.full((), indices.shape[0], dtype=torch.int64,
                       device=indices.device)
    ctx.set(op, 'Accuracy',
            torch.reshape(correct.to(torch.float32) / total, (1, )))
    ctx.set(op, 'Correct', torch.reshape(correct, (1, )))
    ctx.set(op, 'Total', torch.reshape(total, (1, )))
