"""Loss op lowerings (counterpart of ``paddle_tpu/ops/loss_ops.py``:
``cross_entropy`` with hard or soft labels, ``softmax_with_cross_entropy``
with hard or soft labels, and ``sigmoid_cross_entropy_with_logits``,
computed in f32; the regression and ranking losses ``huber_loss``,
``smooth_l1_loss``, ``log_loss``, ``hinge_loss``, ``rank_loss``,
``margin_rank_loss``, ``modified_huber_loss`` and ``kldiv_loss``, each
writing its intermediate outputs too).  ``softmax_with_cross_entropy``
over bf16 logits (AMP) takes the fused path, ``FusedCEBf16``.  Under data
parallelism ``kldiv_loss``'s 'mean', 'sum' and 'batchmean' reduce the
global batch."""

import torch

from .registry import (register_lowering, register_grad_lowering,
                       amp_upcast_f32, declare_dp_aware, dp_scaled_grad)

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


@register_lowering('huber_loss')
def _huber_loss(ctx, op):
    x = ctx.get(op, 'X')
    r = ctx.get(op, 'Y') - x
    delta = op.attrs['delta']
    ar = torch.abs(r)
    ctx.set(op, 'Residual', r)
    ctx.set(op, 'Out', torch.where(ar <= delta, 0.5 * r * r,
                                   delta * (ar - 0.5 * delta)))


@register_lowering('smooth_l1_loss')
def _smooth_l1_loss(ctx, op):
    """Each row's sum of the smooth L1 of (X - Y) (times InsideWeight),
    times OutsideWeight, as [N, 1]; ``Diff`` the weighted difference."""
    sigma = op.attrs.get('sigma', 1.0)
    in_w = ctx.get(op, 'InsideWeight')
    out_w = ctx.get(op, 'OutsideWeight')
    s2 = sigma * sigma
    d = ctx.get(op, 'X') - ctx.get(op, 'Y')
    if in_w is not None:
        d = d * in_w
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    ctx.set(op, 'Diff', d)
    if out_w is not None:
        loss = loss * out_w
    ctx.set(op, 'Out', torch.sum(loss, dim=tuple(range(1, loss.dim())))[:,
                                                                      None])


@register_lowering('log_loss')
def _log_loss(ctx, op):
    p = amp_upcast_f32(ctx.get(op, 'Predicted'))
    label = ctx.get(op, 'Labels')
    eps = op.attrs.get('epsilon', 1e-4)
    ctx.set(op, 'Loss', -label * torch.log(p + eps) -
            (1 - label) * torch.log(1 - p + eps))


@register_lowering('hinge_loss')
def _hinge_loss(ctx, op):
    labels = ctx.get(op, 'Labels')
    ctx.set(op, 'Loss', torch.clamp_min(
        1.0 - (2.0 * labels - 1.0) * ctx.get(op, 'Logits'), 0.0))


@register_lowering('rank_loss')
def _rank_loss(ctx, op):
    """RankNet's pairwise loss log(1 + e^d) - Label d, d = Left - Right."""
    d = amp_upcast_f32(ctx.get(op, 'Left')) - amp_upcast_f32(
        ctx.get(op, 'Right'))
    ctx.set(op, 'Out', torch.log1p(torch.exp(d)) - ctx.get(op, 'Label') * d)


@register_lowering('margin_rank_loss')
def _margin_rank_loss(ctx, op):
    x1 = ctx.get(op, 'X1')
    out = torch.clamp_min(-ctx.get(op, 'Label') * (x1 - ctx.get(op, 'X2')) +
                          op.attrs.get('margin', 0.0), 0.0)
    ctx.set(op, 'Activated', (out > 0).to(x1.dtype))
    ctx.set(op, 'Out', out)


@register_lowering('modified_huber_loss')
def _modified_huber_loss(ctx, op):
    z = (2.0 * ctx.get(op, 'Y') - 1.0) * ctx.get(op, 'X')
    ctx.set(op, 'IntermediateVal', z)
    ctx.set(op, 'Out', torch.where(
        z < -1.0, -4.0 * z,
        torch.where(z < 1.0, torch.square(1.0 - z), torch.zeros_like(z))))


@register_lowering('kldiv_loss')
def _kldiv_loss(ctx, op):
    """Target (log Target - X), X log-probabilities, reduced by
    ``reduction``: 'mean', 'sum', 'batchmean' (the sum over the rows) or
    'none'."""
    x = ctx.get(op, 'X')
    target = ctx.get(op, 'Target')
    loss = target * (torch.log(torch.clamp_min(target, _EPS)) - x)
    reduction = op.attrs.get('reduction', 'mean')
    if reduction != 'none' and ctx.dp_split(op.input('X')[0]):
        # the global batch's reduction: the sum all-reduced, over every
        # rank's elements (rows for 'batchmean'); the grad of a mean
        # scales its cotangent by the local count over the global one
        loss, = ctx.global_sum(torch.sum(loss))
        if reduction != 'sum':
            n = x.numel() if reduction == 'mean' else x.shape[0]
            loss = loss / (n * ctx.dp.world)
            ctx.dp_grad_scale[op.output('Loss')[0]] = torch.full(
                (), 1.0 / ctx.dp.world, device=x.device)
    elif reduction == 'mean':
        loss = torch.mean(loss)
    elif reduction == 'sum':
        loss = torch.sum(loss)
    elif reduction == 'batchmean':
        loss = torch.sum(loss) / x.shape[0]
    ctx.set(op, 'Loss', loss)


register_grad_lowering('kldiv_loss')(dp_scaled_grad('kldiv_loss', 'Loss'))
declare_dp_aware('kldiv_loss', rows=lambda ctx, op: (
    ('Loss', ) if op.attrs.get('reduction', 'mean') == 'none' else ()))
