"""NN op lowerings (counterpart of ``paddle_tpu/ops/nn_ops.py``):
``layer_norm``, ``lookup_table`` and ``dropout``."""

import torch

from .registry import register_lowering, amp_upcast_f32


@register_lowering('layer_norm')
def _layer_norm(ctx, op):
    x = ctx.get(op, 'X')
    scale = ctx.get(op, 'Scale')
    bias = ctx.get(op, 'Bias')
    eps = op.attrs.get('epsilon', 1e-5)
    begin = op.attrs.get('begin_norm_axis', 1)
    axes = tuple(range(begin, x.dim()))
    # statistics accumulate in f32 even when bf16 activations flow in
    xs = amp_upcast_f32(x)
    mean = torch.mean(xs, dim=axes, keepdim=True)
    var = torch.mean(torch.square(xs - mean), dim=axes, keepdim=True)
    y = ((xs - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    norm_shape = (1, ) * begin + tuple(x.shape[begin:])
    if scale is not None:
        y = y * torch.reshape(scale, norm_shape).to(x.dtype)
    if bias is not None:
        y = y + torch.reshape(bias, norm_shape).to(x.dtype)
    ctx.set(op, 'Y', y)
    ctx.set(op, 'Mean', torch.reshape(mean, mean.shape[:begin]))
    ctx.set(op, 'Variance', torch.reshape(var, var.shape[:begin]))


@register_lowering('dropout')
def _dropout(ctx, op):
    x = ctx.get(op, 'X')
    p = op.attrs.get('dropout_prob', 0.5)
    if op.attrs.get('is_test', False) or ctx.is_test:
        # "downgrade_in_infer": scale activations at inference
        ctx.set(op, 'Out', x * (1.0 - p))
        ctx.set(op, 'Mask', torch.ones_like(x))
        return
    keep = torch.rand(x.shape, generator=ctx.generator, device=x.device) >= p
    mask = keep.to(x.dtype)
    ctx.set(op, 'Out', x * mask)
    ctx.set(op, 'Mask', mask)


@register_lowering('lookup_table')
def _lookup_table(ctx, op):
    w = ctx.get(op, 'W')
    ids = ctx.get(op, 'Ids')
    padding_idx = op.attrs.get('padding_idx', -1)
    flat = torch.reshape(ids, (-1, )).long()
    out = torch.index_select(w, 0, flat)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((flat == padding_idx)[:, None], 0.0, out)
    lead = tuple(ids.shape[:-1] if ids.dim() and ids.shape[-1] == 1 else
                 ids.shape)
    ctx.set(op, 'Out', torch.reshape(out, lead + (w.shape[-1], )))
