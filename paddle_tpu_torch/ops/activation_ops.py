"""Activation op lowerings (counterpart of
``paddle_tpu/ops/activation_ops.py``: ``relu`` and ``softmax``)."""

import torch

from .registry import register_lowering, amp_upcast_f32


@register_lowering('relu')
def _relu(ctx, op):
    ctx.set(op, 'Out', torch.relu(ctx.get(op, 'X')))


@register_lowering('softmax')
def _softmax(ctx, op):
    # fluid softmax normalizes the trailing axis; exp/sum in f32 for bf16
    x = ctx.get(op, 'X')
    ctx.set(op, 'Out', torch.softmax(amp_upcast_f32(x), dim=-1).to(x.dtype))
