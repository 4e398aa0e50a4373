"""Loss op lowerings (counterpart of ``paddle_tpu/ops/loss_ops.py``:
``cross_entropy`` with hard or soft labels, ``softmax_with_cross_entropy``
with hard labels, and ``sigmoid_cross_entropy_with_logits``, computed in
f32).  ``softmax_with_cross_entropy`` over bf16 logits (AMP) takes the
fused path, ``FusedCEBf16``."""

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


class FusedCEBf16(torch.autograd.Function):
    """The AMP hard-label cross-entropy over bf16 logits (the JAX
    package's ``_fused_ce_bf16``, a ``jax.custom_vjp``): (loss [N..., 1]
    f32, softmax in the logits' dtype).  The reductions run in f32; the
    softmax kept for the backward and the logits' gradient, (p - onehot)
    scaled by the loss's cotangent, stay bf16, so no f32 [N, V] tensor is
    kept.  Rows whose label is ``ignore`` give 0 and no gradient.  The
    softmax output takes no gradient.  Written in the ``setup_context``
    form, which ``torch.func.vjp`` (the generic grad) accepts."""

    @staticmethod
    def forward(logits, idx, ignore):
        lf = logits.float()
        z = torch.logsumexp(lf, dim=-1, keepdim=True)
        valid = idx != ignore
        picked = torch.gather(lf, -1, torch.where(valid, idx, 0)[..., None])
        loss = torch.where(valid[..., None], z - picked, 0.0)
        return loss, torch.exp(lf - z).to(logits.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, idx, ignore = inputs
        ctx.save_for_backward(output[1], idx)
        ctx.ignore = ignore

    @staticmethod
    def backward(ctx, g_loss, _g_p):
        p, idx = ctx.saved_tensors
        valid = idx != ctx.ignore
        onehot = torch.nn.functional.one_hot(
            torch.where(valid, idx, 0), p.shape[-1]).float()
        scale = torch.where(valid[..., None], g_loss.float(), 0.0)
        return ((p.float() - onehot) * scale).to(p.dtype), None, None


@register_lowering('softmax_with_cross_entropy')
def _softmax_with_cross_entropy(ctx, op):
    raw = ctx.get(op, 'Logits')
    if op.attrs.get('soft_label', False):
        # Label is a distribution over the last axis: loss = -sum(label *
        # log_softmax), f32 throughout (bf16 logits upcast, as the JAX
        # package's soft-label path does); Softmax is an intermediate
        # output its grad never reads, so it carries no gradient
        logits = amp_upcast_f32(raw)
        label = amp_upcast_f32(ctx.get(op, 'Label'))
        log_p = torch.log_softmax(logits, dim=-1)
        ctx.set(op, 'Softmax', torch.exp(log_p).detach())
        ctx.set(op, 'Loss', -(label * log_p).sum(dim=-1, keepdim=True))
        return
    idx = _index_label(ctx.get(op, 'Label'))
    ignore = op.attrs.get('ignore_index', -100)
    if raw.dtype == torch.bfloat16:
        # AMP's hard-label path: every [N, V] tensor it keeps is bf16
        loss, softmax = FusedCEBf16.apply(raw, idx, ignore)
        ctx.set(op, 'Softmax', softmax)
        ctx.set(op, 'Loss', loss)
        return
    logits = amp_upcast_f32(raw)
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
