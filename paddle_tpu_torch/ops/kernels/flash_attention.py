"""Flash-attention forward: the Hopper kernel, its wrapper and its plain
version.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``.  The kernel
(``csrc/flash_attention_fwd.cu``) replaces the Pallas ``_fwd_kernel``: a
blocked online softmax that never writes the [Lq, Lk] scores to device
memory and returns O and the per-row f32 log-sum-exp.

Dispatch is by the tensors' device alone: a CUDA tensor launches the kernel
or raises (unsupported head_dim, dtype, layout, or a failed build or
launch); a CPU tensor takes ``flash_attention_plain``.  Nothing falls back
from the kernel to the plain version.

Layout: [B, L, H, D] at the public functions, read by the kernel as the
contiguous [B, L, H*D] view.  ``seq_lengths`` [B] masks K/V columns at or
past each row's length (clamped to Lk); ``causal`` masks j > i in absolute,
top-left-aligned indices, also when Lq != Lk.  A fully masked row gives
O = 0 and LSE = -1e30.
"""

import ctypes

import torch

from . import _build

__all__ = ['flash_attention', 'flash_attention_fwd', 'flash_attention_plain',
           'check_kernel_args', 'SUPPORTED_HEAD_DIMS', 'LAUNCHES']

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30

# one per kernel launch that the C entry point accepted
LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load('flash_attention_fwd').flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    cols = torch.arange(lk, device=q.device)
    limit = torch.full((b, ), lk, device=q.device) if lens is None else lens
    mask = (cols[None, :] < limit[:, None])[:, None, None, :]
    if causal:
        rows = torch.arange(lq, device=q.device)
        mask = mask & (cols[None, :] <= rows[:, None])[None, None]
    s = s.masked_fill(~mask, float('-inf'))
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)  # masked entries: exp(-inf) = 0
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    o = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    o = torch.where(live, o.transpose(1, 2) / l.clamp_min(1e-30), 0.0)
    lse = torch.where(live, m + torch.log(l.clamp_min(1e-30)), _NEG_INF)
    return o.transpose(1, 2).to(q.dtype), lse[..., 0].transpose(1, 2)


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


def flash_attention(q, k, v, causal=False, scale=None, seq_lengths=None):
    """Blocked flash attention.  q, k, v: [B, L, H, D] (Lq may differ from
    Lk for cross attention); seq_lengths: [B] valid K/V lengths."""
    return flash_attention_fwd(q, k, v, causal, scale, seq_lengths)[0]
