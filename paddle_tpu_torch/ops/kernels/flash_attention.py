"""Flash attention: the Hopper kernels, their wrappers, their plain versions
and the ``torch.autograd.Function`` that joins forward and backward.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``.  Three kernels
replace the three Pallas kernels:

- ``csrc/flash_attention_fwd.cu`` (``_fwd_kernel``): a blocked online
  softmax that never writes the [Lq, Lk] scores to device memory and
  returns O and the per-row f32 log-sum-exp;
- ``csrc/flash_attention_bwd.cu`` ``flash_attention_dq`` (``_dq_kernel``):
  one CTA per Q tile recomputes P = exp(S - LSE) over the K columns and
  writes dQ;
- ``csrc/flash_attention_bwd.cu`` ``flash_attention_dkv`` (``_dkv_kernel``):
  one CTA per K tile walks the Q rows that can see it and writes dK, dV.

delta = rowsum(dO * O), which both backward kernels read, is computed with
torch ops before they launch, as the JAX package computes it with jnp ops
outside its kernels.

``flash_attention`` goes through ``FlashAttention`` (an autograd.Function in
the ``setup_context`` form, so that ``torch.func.vjp`` -- the generic grad of
the ``flash_attention`` op -- can transform it): the forward saves LSE, the
backward launches the two backward kernels.

Dispatch is by the tensors' device alone: a CUDA tensor launches the kernel
or raises (unsupported head_dim, dtype, layout, or a failed build or
launch); a CPU tensor takes the plain version.  Nothing falls back from a
kernel to its plain version.

Layout: [B, L, H, D] at the public functions, read by the kernel as the
contiguous [B, L, H*D] view.  ``seq_lengths`` [B] masks K/V columns at or
past each row's length (clamped to Lk); ``causal`` masks j > i in absolute,
top-left-aligned indices, also when Lq != Lk.  A fully masked row gives
O = 0 and LSE = -1e30, and dQ = 0; K/V rows no query sees get dK = dV = 0.
"""

import ctypes

import torch

from . import _build, unwrapped

__all__ = ['flash_attention', 'flash_attention_fwd', 'flash_attention_plain',
           'flash_attention_bwd', 'flash_attention_bwd_plain',
           'FlashAttention', 'check_kernel_args', 'check_bwd_args',
           'SUPPORTED_HEAD_DIMS', 'LAUNCHES', 'LAUNCHES_DQ', 'LAUNCHES_DKV']

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30

# one per kernel launch that the C entry point accepted: the forward, dQ
# and dK/dV kernels
LAUNCHES = 0
LAUNCHES_DQ = 0
LAUNCHES_DKV = 0

_fn = None
_bwd_fns = None


def _bind(fn, n_ptrs):
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 +
                   [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = _bind(_build.load('flash_attention_fwd').flash_attention_fwd, 6)
    return _fn


def _bwd_kernels():
    """(dq, dkv) C entry points of the backward library."""
    global _bwd_fns
    if _bwd_fns is None:
        lib = _build.load('flash_attention_bwd')
        _bwd_fns = (_bind(lib.flash_attention_dq, 8),
                    _bind(lib.flash_attention_dkv, 9))
    return _bwd_fns


def _lengths(seq_lengths, batch, device):
    if seq_lengths is None:
        return None
    lens = torch.as_tensor(seq_lengths).reshape(-1).to(device=device,
                                                        dtype=torch.int32)
    if lens.numel() != batch:
        raise ValueError('seq_lengths has %d entries for a batch of %d' %
                         (lens.numel(), batch))
    return lens.contiguous()


def check_kernel_args(q, k, v):
    """Raise ValueError for inputs the kernel does not take: shapes, head
    dims outside SUPPORTED_HEAD_DIMS or differing between Q and V, dtypes
    other than float32/bfloat16 or mixed, non-contiguous layouts, data not
    aligned for the kernel's 4-element vector loads, and tensors not on one
    CUDA device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError('flash_attention: q, k, v must be [B, L, H, D], got '
                         '%s %s %s' % (tuple(q.shape), tuple(k.shape),
                                       tuple(v.shape)))
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or \
            k.shape[3] != d:
        raise ValueError('flash_attention kernel: k and v must be [%d, Lk, '
                         '%d, %d], got %s and %s' % (b, h, d, tuple(k.shape),
                                                     tuple(v.shape)))
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError('flash_attention kernel: head_dim %d is not one of '
                         '%s' % (d, SUPPORTED_HEAD_DIMS))
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError('flash_attention kernel: q, k, v must all be '
                         'float32 or all bfloat16, got %s %s %s' %
                         (q.dtype, k.dtype, v.dtype))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError('flash_attention kernel: q, k, v must be contiguous '
                         '[B, L, H*D] rows')
    align = 4 * q.element_size()  # float4 (f32) / uint2 (bf16) accesses
    if any(t.data_ptr() % align for t in (q, k, v)):
        raise ValueError('flash_attention kernel: q, k, v data must be '
                         '%d-byte aligned (a view at an odd storage offset '
                         'is not)' % align)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError('flash_attention kernel: q, k, v must lie on one '
                         'CUDA device, got %s %s %s' % (q.device, k.device,
                                                        v.device))


def check_bwd_args(q, k, v, o, lse, do):
    """``check_kernel_args`` for the backward kernels, plus O and dO (q's
    shape, dtype, layout, alignment and device) and LSE ([B, Lq, H] f32,
    contiguous, on q's device)."""
    check_kernel_args(q, k, v)
    for name, t in (('o', o), ('do', do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError('flash_attention backward kernels: %s must be '
                             'like q (%s %s), got %s %s' %
                             (name, tuple(q.shape), q.dtype, tuple(t.shape),
                              t.dtype))
        if not t.is_contiguous():
            raise ValueError('flash_attention backward kernels: %s must be '
                             'contiguous [B, L, H*D] rows' % name)
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError('flash_attention backward kernels: %s data must '
                             'be %d-byte aligned' % (name,
                                                     4 * t.element_size()))
        if t.device != q.device:
            raise ValueError('flash_attention backward kernels: %s is on %s, '
                             'q on %s' % (name, t.device, q.device))
    b, lq, h, _ = q.shape
    if tuple(lse.shape) != (b, lq, h) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError('flash_attention backward kernels: lse must be a '
                         'contiguous float32 [%d, %d, %d] on %s, got %s %s '
                         'on %s' % (b, lq, h, q.device, tuple(lse.shape),
                                    lse.dtype, lse.device))


def _launch(q, k, v, causal, scale, lens):
    global LAUNCHES
    check_kernel_args(q, k, v)
    b, lq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, lq, h), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if lens is None else lens.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, lq, k.shape[1], h, d, scale, int(causal),
                _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError('flash_attention_fwd kernel launch failed: CUDA '
                           'error %d' % rc)
    LAUNCHES += 1
    return o, lse


def _launch_dq(q, k, v, do, lse, delta, lens, causal, scale):
    """dQ kernel: q, k, v, do checked by the caller (check_bwd_args)."""
    global LAUNCHES_DQ
    b, lq, h, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _bwd_kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if lens is None else lens.data_ptr(), dq.data_ptr(), b, lq,
            k.shape[1], h, d, scale, int(causal), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError('flash_attention_dq kernel launch failed: CUDA '
                           'error %d' % rc)
    LAUNCHES_DQ += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, lens, causal, scale):
    """dK/dV kernel: inputs checked by the caller (check_bwd_args)."""
    global LAUNCHES_DKV
    b, lq, h, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = _bwd_kernels()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if lens is None else lens.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, lq, k.shape[1], h, d, scale, int(causal),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError('flash_attention_dkv kernel launch failed: CUDA '
                           'error %d' % rc)
    LAUNCHES_DKV += 1
    return dk, dv


def bwd_delta(o, do):
    """delta[b, i, h] = rowsum(dO * O) per head, f32 [B, Lq, H]."""
    return (do.float() * o.float()).sum(-1).contiguous()


def _launch_bwd(q, k, v, o, lse, do, causal, scale, lens):
    check_bwd_args(q, k, v, o, lse, do)
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = bwd_delta(o, do)
    dq = _launch_dq(q, k, v, do, lse, delta, lens, causal, scale)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, lens, causal, scale)
    return dq, dk, dv


def _mask(b, lq, lk, causal, lens, device):
    """[B, 1, Lq, Lk] bool: True where row i may attend column j."""
    cols = torch.arange(lk, device=device)
    limit = torch.full((b, ), lk, device=device) if lens is None else lens
    mask = (cols[None, :] < limit[:, None])[:, None, None, :]
    if causal:
        rows = torch.arange(lq, device=device)
        mask = mask & (cols[None, :] <= rows[:, None])[None, None]
    return mask.expand(b, 1, lq, lk)


def flash_attention_plain(q, k, v, causal=False, scale=None,
                          seq_lengths=None):
    """The kernel's function in plain PyTorch, in f32: (O [B, Lq, H, D] in
    q's dtype, LSE [B, Lq, H] f32).  Used on CPU tensors and as the
    reference the kernel is held to."""
    scale = float(scale) if scale is not None else q.shape[-1]**-0.5
    b, lq = q.shape[0], q.shape[1]
    lk = k.shape[1]
    lens = _lengths(seq_lengths, b, q.device)
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    mask = _mask(b, lq, lk, causal, lens, q.device)
    s = s.masked_fill(~mask, float('-inf'))
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)  # masked entries: exp(-inf) = 0
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    o = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    o = torch.where(live, o.transpose(1, 2) / l.clamp_min(1e-30), 0.0)
    lse = torch.where(live, m + torch.log(l.clamp_min(1e-30)), _NEG_INF)
    return (o.transpose(1, 2).to(q.dtype).contiguous(),
            lse[..., 0].transpose(1, 2).contiguous())


def flash_attention_fwd(q, k, v, causal=False, scale=None,
                        seq_lengths=None):
    """(O, LSE) of blocked flash attention.  q: [B, Lq, H, D]; k, v:
    [B, Lk, H, D]; seq_lengths: [B] valid K/V lengths.  O has q's shape
    and dtype, LSE is [B, Lq, H] f32 (kept for the backward)."""
    scale = float(scale) if scale is not None else q.shape[-1]**-0.5
    if q.is_cuda:
        return _launch(q, k, v, bool(causal), scale,
                       _lengths(seq_lengths, q.shape[0], q.device))
    if k.is_cuda or v.is_cuda:
        raise ValueError('flash_attention: q is on the CPU but k/v are on '
                         '%s/%s' % (k.device, v.device))
    return flash_attention_plain(q, k, v, causal, scale, seq_lengths)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None,
                              seq_lengths=None):
    """The backward kernels' function in plain PyTorch, in f32: (dQ, dK, dV)
    in the inputs' dtypes, with P recomputed from LSE as the kernels do.
    Used on CPU tensors and as the reference the kernels are held to."""
    scale = float(scale) if scale is not None else q.shape[-1]**-0.5
    b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
    mask = _mask(b, lq, lk, causal, _lengths(seq_lengths, b, q.device),
                 q.device)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum('bqhd,bkhd->bhqk', qf, kf) * scale
    # the mask applies before the exponential: masked entries are exactly 0
    # and a fully masked row (LSE = -1e30) never forms exp(s + 1e30)
    p = torch.exp((s - lse.transpose(1, 2)[..., None]).masked_fill(
        ~mask, float('-inf')))
    delta = bwd_delta(o, do).transpose(1, 2)[..., None]
    dp = torch.einsum('bqhd,bkhd->bhqk', dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, kf)
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, qf)
    dv = torch.einsum('bhqk,bqhd->bkhd', p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None,
                        seq_lengths=None):
    """(dQ, dK, dV) of flash attention from the forward's O and LSE and the
    output gradient dO.  Shapes as ``flash_attention_fwd``."""
    scale = float(scale) if scale is not None else q.shape[-1]**-0.5
    if q.is_cuda:
        return _launch_bwd(q, k, v, o, lse, do, bool(causal), scale,
                           _lengths(seq_lengths, q.shape[0], q.device))
    if any(t.is_cuda for t in (k, v, o, lse, do)):
        raise ValueError('flash_attention backward: q is on the CPU but '
                         'another input is on a CUDA device')
    return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                     seq_lengths)


class FlashAttention(torch.autograd.Function):
    """(O, LSE) = flash attention of (q, k, v); gradients flow to q, k, v
    through the backward kernels.

    It is written in the ``setup_context`` form, the one ``torch.func``
    transforms accept: ``forward`` takes no ctx, and ``setup_context`` sees
    only inputs and outputs, so LSE is an output (marked non-differentiable)
    in order to be saved.  ``causal``, ``scale`` and ``seq_lengths`` get no
    gradient."""

    @staticmethod
    def forward(q, k, v, causal, scale, seq_lengths):
        return flash_attention_fwd(q, k, v, causal, scale, seq_lengths)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, scale, seq_lengths = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse, seq_lengths)
        ctx.causal = causal
        ctx.scale = scale

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, seq_lengths, do = (
            unwrapped(t) for t in ctx.saved_tensors + (do, ))
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale, seq_lengths)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, seq_lengths=None):
    """Blocked flash attention, differentiable in q, k and v.  q, k, v:
    [B, L, H, D] (Lq may differ from Lk for cross attention); seq_lengths:
    [B] valid K/V lengths."""
    scale = float(scale) if scale is not None else q.shape[-1]**-0.5
    return FlashAttention.apply(q, k, v, bool(causal), scale,
                                _lengths(seq_lengths, q.shape[0], q.device))[0]
