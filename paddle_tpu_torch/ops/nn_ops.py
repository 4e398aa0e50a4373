"""NN op lowerings (counterpart of ``paddle_tpu/ops/nn_ops.py``):
``conv2d`` and ``depthwise_conv2d`` (``torch.nn.functional.conv2d``, cuDNN
on the card; OIHW filters), ``pool2d``, ``batch_norm``, ``layer_norm``,
``lookup_table`` and ``dropout``, with the explicit grad of ``dropout``
(it reuses the forward Mask: a generic vjp would draw anew).
``lookup_table``'s grad, dense or sparse, lives in ``sparse.py``, as in the
JAX package.  Under AMP the convolutions run in bf16 and land bf16;
``batch_norm`` and ``layer_norm`` take their statistics in f32 and give
their output in X's dtype.

Under data parallelism a training ``batch_norm`` over rows the ranks split
takes the global batch's statistics, as the JAX package's one program over
the global batch does: the per-channel sums of x and x^2 all-reduced with
the rows, the running statistics updated from them.  Its explicit grad then
all-reduces its two per-channel sums (of dy, and of dy times the
normalized x) for dX; the Scale and Bias gradients stay this rank's partial
sums, which the executor's gradient all-reduce completes.  Without dp the
grad is the generic one.
"""

import math

import torch
import torch.nn.functional as F

from .registry import (register_lowering, register_grad_lowering,
                       amp_cast_in, amp_cast_out, amp_upcast_f32,
                       fwd_structure, declare_dp_aware, store_grad,
                       _make_generic_grad, GRAD_SUFFIX)


def _pair(v):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v, v]


def _conv(ctx, op, groups):
    # under AMP both operands go to bf16 (cuDNN's bf16 convolution
    # accumulates in f32) and the output lands in bf16; batch norm takes
    # its statistics in f32
    x, w = amp_cast_in(ctx.get(op, 'Input'), ctx.get(op, 'Filter'))
    out = F.conv2d(x, w,
                   stride=_pair(op.attrs.get('strides', [1, 1])),
                   padding=_pair(op.attrs.get('paddings', [0, 0])),
                   dilation=_pair(op.attrs.get('dilations', [1, 1])),
                   groups=groups)
    ctx.set(op, 'Output', amp_cast_out(out))


@register_lowering('conv2d')
def _conv2d(ctx, op):
    _conv(ctx, op, op.attrs.get('groups', 1) or 1)


@register_lowering('depthwise_conv2d')
def _depthwise_conv2d(ctx, op):
    _conv(ctx, op, ctx.get(op, 'Input').shape[1])


def _pool2d_pads(op, x):
    """(ksize, strides, [(low, high)] pads, ceil padding added) as the
    reference's ``_pool`` reads the attrs: ``global_pooling`` takes the
    whole plane; ``ceil_mode`` pads the high side so that the last partial
    window is kept, where torch's ceil_mode drops a window that would start
    in the padding."""
    ksize = list(op.attrs.get('ksize'))
    strides = list(op.attrs.get('strides', [1, 1]))
    paddings = list(op.attrs.get('paddings', [0, 0]))
    ceil_mode = op.attrs.get('ceil_mode', False)
    if op.attrs.get('global_pooling', False):
        ksize = list(x.shape[2:])
        paddings = [0, 0]
        strides = [1, 1]
        ceil_mode = False
    pads, padded_extra = [], False
    for i, p in enumerate(paddings):
        extra = 0
        if ceil_mode:
            size = x.shape[2 + i]
            out_ceil = -(-(size + 2 * p - ksize[i]) // strides[i]) + 1
            extra = max((out_ceil - 1) * strides[i] + ksize[i] -
                        (size + 2 * p), 0)
            padded_extra = padded_extra or extra > 0
        pads.append((p, p + extra))
    return ksize, strides, pads, padded_extra


@register_lowering('pool2d')
def _pool2d(ctx, op):
    x = ctx.get(op, 'X')
    ksize, strides, pads, padded_extra = _pool2d_pads(op, x)
    is_max = op.attrs.get('pooling_type', 'max') == 'max'
    # avg: exclusive=True divides by the in-bounds count only where the
    # window can reach padding (reference nn_ops.py _pool)
    exclusive = (op.attrs.get('exclusive', True) and
                 any(lo > 0 for lo, _ in pads)) or padded_extra
    if all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, ksize)):
        # torch's own symmetric padding: -inf for max, and for avg the
        # in-bounds count (count_include_pad=False) or the window's size
        pad = [lo for lo, _ in pads]
        if is_max:
            out = F.max_pool2d(x, ksize, strides, pad)
        else:
            out = F.avg_pool2d(x, ksize, strides, pad,
                               count_include_pad=not exclusive)
        ctx.set(op, 'Out', out)
        return
    # wider or one-sided padding: pad explicitly, then pool unpadded
    flat = [pads[1][0], pads[1][1], pads[0][0], pads[0][1]]
    if is_max:
        out = F.max_pool2d(F.pad(x, flat, value=-math.inf), ksize, strides)
    else:
        summed = F.avg_pool2d(F.pad(x, flat), ksize, strides,
                              divisor_override=1)
        if exclusive:
            ones = F.pad(torch.ones_like(x[:1, :1]), flat)
            counts = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
            out = summed / torch.clamp(counts, min=1.0)
        else:
            out = summed / math.prod(ksize)
    ctx.set(op, 'Out', out)


@register_lowering('batch_norm')
def _batch_norm(ctx, op):
    """The reference's arithmetic: batch statistics mean = E[x] and the
    biased var = E[x^2] - E[x]^2; running stats updated as m * running +
    (1 - m) * batch (m = ``momentum``, 0.9), on the biased variance and
    from detached batch statistics, into new tensors.  (F.batch_norm's
    running update takes the unbiased variance, its momentum is 1 - m, and
    it writes the buffers in place, which a lowering replayed under
    torch.func.vjp must not.)

    An explicit ``use_global_stats`` picks the statistics in both
    directions; absent, ``is_test`` does.  The running stats move only in
    training (not ``is_test``) on batch statistics."""
    x = ctx.get(op, 'X')
    scale = ctx.get(op, 'Scale')
    bias = ctx.get(op, 'Bias')
    mean_in = ctx.get(op, 'Mean')
    var_in = ctx.get(op, 'Variance')
    eps = op.attrs.get('epsilon', 1e-5)
    momentum = op.attrs.get('momentum', 0.9)
    is_test = op.attrs.get('is_test', False)
    ugs = op.attrs.get('use_global_stats', None)
    use_running = bool(ugs) if ugs is not None else bool(is_test)
    update_running = (not use_running) and (not is_test)
    channel = 1 if op.attrs.get('data_layout', 'NCHW') == 'NCHW' \
        else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != channel)
    bshape = [1] * x.dim()
    bshape[channel] = -1

    xs = amp_upcast_f32(x)
    if use_running:
        mean, var = mean_in, var_in
        mean_out, var_out = mean_in, var_in
    else:
        if ctx.dp_split(op.input('X')[0]):
            # the global batch's statistics: E[x] and E[x^2] over every
            # rank's rows (padding rows count, as the JAX package's do)
            n = xs.numel() // xs.shape[channel] * ctx.dp.world
            total, squares = ctx.global_sum(
                torch.sum(xs, dim=axes), torch.sum(torch.square(xs),
                                                   dim=axes))
            mean = total / n
            var = squares / n - torch.square(mean)
        else:
            mean = torch.mean(xs, dim=axes)
            var = torch.mean(torch.square(xs), dim=axes) - \
                torch.square(mean)
        if update_running:
            mean_out = momentum * mean_in + (1 - momentum) * mean.detach()
            var_out = momentum * var_in + (1 - momentum) * var.detach()
        else:
            mean_out, var_out = mean_in, var_in
    inv_std = torch.rsqrt(torch.reshape(var, bshape) + eps)
    y = (xs - torch.reshape(mean, bshape)) * inv_std * torch.reshape(
        scale, bshape) + torch.reshape(bias, bshape)
    ctx.set(op, 'Y', y.to(x.dtype))
    ctx.set(op, 'MeanOut', mean_out)
    ctx.set(op, 'VarianceOut', var_out)
    ctx.set(op, 'SavedMean', mean)
    ctx.set(op, 'SavedVariance', var)


_batch_norm_generic_grad = []


@register_grad_lowering('batch_norm')
def _batch_norm_grad(ctx, op):
    """Training batch norm over rows that data-parallel ranks split: dX
    from the global statistics (SavedMean, SavedVariance) and the global
    sums of dy and of dy times x-hat over the channel, all-reduced in one
    collective; dScale and dBias this rank's partial sums.  Otherwise (no
    dp, running statistics) the generic grad."""
    fwd_in, fwd_out, attrs = fwd_structure(op)
    x_name = fwd_in['X'][0]
    ugs = attrs.get('use_global_stats', None)
    use_running = bool(ugs) if ugs is not None else \
        bool(attrs.get('is_test', False))
    if use_running or not ctx.dp_split(x_name):
        if not _batch_norm_generic_grad:
            _batch_norm_generic_grad.append(_make_generic_grad('batch_norm'))
        return _batch_norm_generic_grad[0](ctx, op)
    x = ctx.lookup(x_name)
    y_ct = fwd_out['Y'][0] + GRAD_SUFFIX
    scale = ctx.lookup(fwd_in['Scale'][0])
    mean = ctx.lookup(fwd_out['SavedMean'][0])
    var = ctx.lookup(fwd_out['SavedVariance'][0])
    eps = attrs.get('epsilon', 1e-5)
    channel = 1 if attrs.get('data_layout', 'NCHW') == 'NCHW' \
        else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != channel)
    bshape = [1] * x.dim()
    bshape[channel] = -1
    xs = amp_upcast_f32(x)
    dy = ctx.lookup(y_ct).to(xs.dtype) if ctx.has(y_ct) else \
        torch.zeros_like(xs)
    inv_std = torch.rsqrt(var + eps)
    xhat = (xs - torch.reshape(mean, bshape)) * torch.reshape(inv_std, bshape)
    dbias = torch.sum(dy, dim=axes)
    dscale = torch.sum(dy * xhat, dim=axes)
    n = xs.numel() // xs.shape[channel] * ctx.dp.world
    sum_dy, sum_dy_xhat = ctx.global_sum(dbias, dscale)
    dx = torch.reshape(scale * inv_std / n, bshape) * (
        n * dy - torch.reshape(sum_dy, bshape) -
        xhat * torch.reshape(sum_dy_xhat, bshape))
    grads = (('X', dx.to(x.dtype)), ('Scale', dscale.to(scale.dtype)),
             ('Bias', dbias.to(scale.dtype)))
    for slot, g in grads:
        for gname in op.output(slot + GRAD_SUFFIX)[:1]:
            if gname:
                store_grad(ctx, gname, g, cotangents={y_ct})


declare_dp_aware('batch_norm', rows=lambda ctx, op: ('Y', ))


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


@register_grad_lowering('dropout')
def _dropout_grad(ctx, op):
    _, fwd_outputs, attrs = fwd_structure(op)
    dout = ctx.lookup(fwd_outputs['Out'][0] + GRAD_SUFFIX)
    gnames = op.output('X' + GRAD_SUFFIX)
    if not gnames:
        return
    if attrs.get('is_test', False) or ctx.is_test:
        ctx.store(gnames[0], dout * (1.0 - attrs.get('dropout_prob', 0.5)))
    else:
        ctx.store(gnames[0], dout * ctx.lookup(fwd_outputs['Mask'][0]))


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
