"""Fused scaled-dot-product attention op (counterpart of
``paddle_tpu/ops/attention_ops.py``).

``impl='auto'`` (and ``'pallas'``, the JAX package's name for the flash
kernel) runs ``ops/kernels/flash_attention``: the hand-written Hopper kernels
for CUDA tensors, their plain versions for CPU tensors.  It goes through the
``FlashAttention`` autograd.Function, so the op's generic grad
(``torch.func.vjp`` of this lowering) replays the forward kernel and then
runs the dQ and dK/dV kernels.  The JAX package keeps
dense XLA attention below a score-size budget measured on a TPU v5e
(``_DENSE_SCORE_BYTES_BUDGET``); that threshold does not carry over to the
card and is not used here.  V's head_dim differing from Q's runs
``dense_attention`` by shape, as in the JAX package; any other shape goes to
the kernel, whose wrapper raises on a CUDA tensor for a head_dim outside
``SUPPORTED_HEAD_DIMS`` rather than taking the plain version.
``impl='dense'`` asks for the dense path explicitly.  ``'ring'`` and
``'ulysses'`` (the 'sp' mesh axis) raise: the port runs data parallelism
only (ROADMAP.md, Queue 1 item 7).

Layout: Q, K, V are [batch, seq, heads, head_dim].  K's ``@SEQLEN``
side-band, when present, masks K/V columns past each row's length.
"""

from . import registry
from .registry import register_lowering, amp_cast_in
from .kernels import flash_attention as fa
from ..parallel.context_parallel import dense_attention


def _pick_impl(op, q, v):
    impl = op.attrs.get('impl', 'auto')
    if impl in ('ring', 'ulysses'):
        raise NotImplementedError(
            'flash_attention impl=%r needs the \'sp\' mesh axis, which the '
            'PyTorch port does not run yet (ROADMAP.md, Queue 1 item 7)'
            % impl)
    if impl == 'dense':
        return 'dense'
    if impl not in ('auto', 'pallas'):
        raise ValueError('flash_attention: unknown impl %r' % impl)
    if v.shape[-1] != q.shape[-1]:
        return 'dense'
    return 'kernel'


@register_lowering('flash_attention')
def flash_attention_lowering(ctx, op):
    q, k, v = amp_cast_in(ctx.get(op, 'Q'), ctx.get(op, 'K'),
                          ctx.get(op, 'V'))
    causal = bool(op.attrs.get('causal', False))
    scale = op.attrs.get('scale', None)
    if scale is not None and scale <= 0:
        scale = None
    # only K's own side-band applies: Q's lengths describe the query
    # sequence and must NOT mask encoder memory in cross-attention
    lens = ctx.env.get(op.input('K')[0] + registry.SEQLEN_SUFFIX)
    if _pick_impl(op, q, v) == 'kernel':
        out = fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                 seq_lengths=lens)
    else:
        out = dense_attention(q, k, v, causal=causal, scale=scale,
                              seq_lengths=lens)
    ctx.set(op, 'Out', out.to(q.dtype))
