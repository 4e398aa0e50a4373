"""NN op lowerings (counterpart of ``paddle_tpu/ops/nn_ops.py``):
``layer_norm``, ``lookup_table`` and ``dropout``, with the explicit grads of
``dropout`` (it reuses the forward Mask: a generic vjp would draw anew) and
of ``lookup_table`` (the dense scatter-add of ``paddle_tpu/ops/sparse.py``).
"""

import torch

from .registry import (register_lowering, register_grad_lowering,
                       amp_upcast_f32, fwd_structure, GRAD_SUFFIX)


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


@register_grad_lowering('lookup_table')
def _lookup_table_grad(ctx, op):
    fwd_inputs, fwd_outputs, fwd_attrs = fwd_structure(op)
    gnames = op.output('W' + GRAD_SUFFIX)
    if not gnames or not gnames[0]:
        return
    if fwd_attrs.get('is_sparse', False):
        raise NotImplementedError('lookup_table with is_sparse=True needs '
                                  'SparseRows gradients, not ported yet')
    gname = gnames[0]
    w = ctx.lookup(fwd_inputs['W'][0])
    flat = torch.reshape(ctx.lookup(fwd_inputs['Ids'][0]), (-1, )).long()
    vals = torch.reshape(ctx.lookup(fwd_outputs['Out'][0] + GRAD_SUFFIX),
                         (flat.shape[0], w.shape[-1])).to(w.dtype)
    padding_idx = fwd_attrs.get('padding_idx', -1)
    if padding_idx is not None and padding_idx >= 0:
        vals = torch.where((flat == padding_idx)[:, None], 0.0, vals)
    g = torch.zeros_like(w).index_add_(0, flat, vals)
    if ctx.has(gname):
        g = ctx.lookup(gname) + g
    ctx.store(gname, g)
