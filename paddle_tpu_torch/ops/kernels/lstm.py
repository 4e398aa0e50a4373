"""The LSTM recurrence: the Hopper kernels, their wrappers, their plain
versions and the ``torch.autograd.Function`` that joins forward and backward.

Counterpart of ``paddle_tpu/ops/pallas/lstm.py``.  Kernels:

- ``csrc/lstm_fwd.cu`` ``lstm_fwd`` (``_fwd_kernel``): the whole recurrence
  in one launch; a cluster of CTAs per 4 batch rows walks T in a loop, each
  CTA holding its units' gate columns of W in shared memory and sending its
  new h to every CTA of the cluster each step (``fwd_cluster`` gives the
  cluster's size); returns hs, cs and, when asked, the gate activations the
  backward needs;
- ``csrc/lstm_bwd.cu`` ``lstm_bwd`` (``_bwd_kernel``'s reverse-time walk):
  dx, dh0, dc0 and per-cluster f32 partial sums of db; a cluster of CTAs
  per 4 batch rows holds W in its shared memory (``walk_cluster`` gives its
  size);
- ``csrc/lstm_bwd.cu`` ``lstm_bwd_dw`` (``_bwd_kernel``'s dW and db
  accumulators): dW = sum over (t, b) of h_prev^T . dg16 on the tensor
  cores (3xTF32) as split-K partial products summed in a fixed order, and
  db from the walk's partials.

Layout is time-major, as the JAX package's: xs [T, B, 4D] pre-projected
gates (order candidate, input, forget, output), w [D, 4D], bias [1, 4D] f32,
h0 [B, D] in x's dtype, c0 [B, D] f32, mask [T, B] f32 in {0, 1}.  hs is in
x's dtype, cs in f32.  x, w, h0 are float32 or bfloat16.

Dispatch is by the tensors' device alone: a CUDA tensor launches the kernel
or raises (a shape ``kernel_takes`` refuses, another dtype, a layout, or a
failed build or launch); a CPU tensor takes the plain version.  Nothing falls
back from a kernel to its plain version.

``lstm_fused_tm`` mirrors ``_lstm_core``: called where no gradient is asked
for, it launches the forward without writing the [T, B, 4D] activations;
where one is (under ``torch.func.vjp``, the op's generic grad), it goes
through ``LSTMCore``, whose forward saves them and whose backward launches
the walk and the dW kernels.
"""

import ctypes
import math

import torch

from . import _build, unwrapped
from ..registry import register_counter

__all__ = ['lstm_fused_tm', 'lstm_fwd', 'lstm_bwd', 'lstm_fwd_plain',
           'lstm_bwd_plain', 'LSTMCore', 'kernel_takes', 'check_fwd_args',
           'check_bwd_args', 'fwd_cluster', 'walk_cluster',
           'fwd_cluster_sizes', 'walk_cluster_sizes', 'LAUNCHES_FWD',
           'LAUNCHES_BWD', 'LAUNCHES_DW']

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# one per kernel launch the C entry points accepted: the forward, the
# backward walk, and the dW entry point (its split-K products and their
# reduction with db)
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
LAUNCHES_DW = 0
# a capture records how far these grew (the block's captured_launches); its
# replays launch the kernels without a wrapper call
register_counter(lambda: {'lstm_fwd': LAUNCHES_FWD, 'lstm_bwd': LAUNCHES_BWD,
                          'lstm_dw': LAUNCHES_DW})

# cluster sizes a caller may ask of the kernels (0: the library's choice)
CLUSTER_SIZES = (0, 1, 2, 4, 8)

_fwd_fns = None
_bwd_fns = None


def _kernel_fwd():
    """(forward, cluster size, plan) of the forward library: the forward with
    a chosen cluster size (0: the library's choice), the library's choice,
    and its plan's verdict on a cluster size."""
    global _fwd_fns
    if _fwd_fns is None:
        lib = _build.load('lstm_fwd')
        fn = lib.lstm_fwd_with_cluster
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        cluster, fit = lib.lstm_fwd_cluster, lib.lstm_fwd_fit
        cluster.argtypes, fit.argtypes = [ctypes.c_int] * 3, [ctypes.c_int] * 3
        cluster.restype = fit.restype = ctypes.c_int
        _fwd_fns = (fn, cluster, fit)
    return _fwd_fns


def _kernels_bwd():
    """(walk, dw, rows per walk cluster, cluster size, dW tile depth, plan)
    of the backward library: the walk with a chosen cluster size (0: the
    library's choice), the dW entry point, the library's constants and
    choice, and the walk's plan's verdict on a cluster size."""
    global _bwd_fns
    if _bwd_fns is None:
        lib = _build.load('lstm_bwd')
        walk = lib.lstm_bwd_with_cluster
        walk.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        walk.restype = ctypes.c_int
        dw = lib.lstm_bwd_dw
        dw.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        dw.restype = ctypes.c_int
        cluster, fit = lib.lstm_bwd_cluster, lib.lstm_bwd_fit
        cluster.argtypes, fit.argtypes = [ctypes.c_int] * 3, [ctypes.c_int] * 3
        cluster.restype = fit.restype = ctypes.c_int
        for fn in (lib.lstm_bwd_rows_per_block, lib.lstm_bwd_dw_tile):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        _bwd_fns = (walk, dw, int(lib.lstm_bwd_rows_per_block()), cluster,
                    int(lib.lstm_bwd_dw_tile()), fit)
    return _bwd_fns


def _cluster(choose, name, batch, d, dtype):
    with torch.cuda.device(torch.cuda.current_device()):
        n = choose(batch, d, _DTYPE_CODES[dtype])
    if n < 1:
        raise RuntimeError('%s failed for B=%d, D=%d, %s' % (name, batch, d,
                                                            dtype))
    return n


def fwd_cluster(batch, d, dtype):
    """The number of CTAs in each cluster of the forward kernel for a batch,
    a hidden width and a dtype, as the current CUDA device launches it."""
    return _cluster(_kernel_fwd()[1], 'lstm_fwd_cluster', batch, d, dtype)


def walk_cluster(batch, d, dtype):
    """The number of CTAs in each cluster of the walk kernel for a batch, a
    hidden width and a dtype, as the current CUDA device launches it."""
    return _cluster(_kernels_bwd()[3], 'lstm_bwd_cluster', batch, d, dtype)


def fwd_cluster_sizes(d, dtype):
    """The cluster sizes the forward kernel's plan takes at hidden width
    ``d`` and a dtype (``_launch_fwd``'s ``cluster`` may be any of them)."""
    fit, code = _kernel_fwd()[2], _DTYPE_CODES[dtype]
    return [n for n in CLUSTER_SIZES[1:] if fit(d, code, n) >= 0]


def walk_cluster_sizes(d, dtype):
    """The cluster sizes the walk kernel's plan takes at hidden width ``d``
    and a dtype (``_launch_walk``'s ``cluster`` may be any of them)."""
    fit, code = _kernels_bwd()[5], _DTYPE_CODES[dtype]
    return [n for n in CLUSTER_SIZES[1:] if fit(d, code, n) >= 0]


def kernel_takes(d, batch, dtype):
    """Whether the kernels take a hidden width ``d``, a batch and a dtype:
    d a multiple of 32 in [32, 512] (each has a cluster size for every such
    d), any batch >= 1 (ragged rows are masked in the kernel), float32 or
    bfloat16."""
    return (d % 32 == 0 and 32 <= d <= 512 and batch >= 1 and
            dtype in _DTYPE_CODES)


def _check_like(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError('lstm kernel: %s must be %s %s, got %s %s' %
                         (name, tuple(shape), dtype, tuple(t.shape), t.dtype))
    if not t.is_contiguous():
        raise ValueError('lstm kernel: %s must be contiguous' % name)
    if t.device != device:
        raise ValueError('lstm kernel: %s is on %s, not %s' %
                         (name, t.device, device))


def _check_recurrence(name, x, w, h0, c0, mask):
    """The arguments both kernels read: x ([T, B, 4D] xs or acts), w, h0, c0
    and mask, all on x's device.  Returns (T, B, D)."""
    if x.dim() != 3 or x.shape[2] % 4:
        raise ValueError('lstm kernel: %s must be [T, B, 4D], got %s' %
                         (name, tuple(x.shape)))
    t, b, d4 = x.shape
    d = d4 // 4
    if t < 1 or not kernel_takes(d, b, x.dtype):
        raise ValueError('lstm kernel: T=%d, B=%d, D=%d, %s is not taken (D '
                         'a multiple of 32 in [32, 512], B and T >= 1, '
                         'float32 or bfloat16)' % (t, b, d, x.dtype))
    _check_like(name, x, x.shape, x.dtype, x.device)
    _check_like('w', w, (d, d4), x.dtype, x.device)
    _check_like('h0', h0, (b, d), x.dtype, x.device)
    _check_like('c0', c0, (b, d), torch.float32, x.device)
    _check_like('mask', mask, (t, b), torch.float32, x.device)
    return t, b, d


def check_fwd_args(xs, w, bias, h0, c0, mask):
    """Raise ValueError for inputs the forward kernel does not take: shapes,
    a width or dtype ``kernel_takes`` refuses, mixed dtypes, non-contiguous
    layouts, and tensors not on one CUDA device."""
    _, _, d = _check_recurrence('xs', xs, w, h0, c0, mask)
    _check_like('bias', bias, (1, 4 * d), torch.float32, xs.device)
    _check_cuda(xs)


def check_bwd_args(w, mask, acts, cs, hs, h0, c0, dhs, dcs):
    """``check_fwd_args`` for the backward kernels: acts [T, B, 4D] in w's
    dtype, hs and dhs [T, B, D] in w's dtype, cs and dcs [T, B, D] f32."""
    t, b, d = _check_recurrence('acts', acts, w, h0, c0, mask)
    for name, x, dtype in (('cs', cs, torch.float32), ('hs', hs, w.dtype),
                           ('dhs', dhs, w.dtype), ('dcs', dcs, torch.float32)):
        _check_like(name, x, (t, b, d), dtype, acts.device)
    _check_cuda(acts)


def _check_cuda(x):
    if not x.is_cuda:
        raise ValueError('lstm kernel: the inputs must lie on a CUDA device, '
                         'got %s' % x.device)


def _check_cluster(cluster):
    if cluster not in CLUSTER_SIZES:
        raise ValueError('lstm kernel: cluster must be one of %s (0: the '
                         'library\'s choice), got %r' % (CLUSTER_SIZES,
                                                          cluster))


def _launch_fwd(xs, w, bias, h0, c0, mask, save_acts, cluster=0):
    """(hs, cs, acts or None) from the forward kernel, with clusters of
    ``cluster`` CTAs (0: ``fwd_cluster``'s choice; a size the kernel does
    not take for this D, or the card cannot place, raises)."""
    global LAUNCHES_FWD
    _check_cluster(cluster)
    check_fwd_args(xs, w, bias, h0, c0, mask)
    t, b, d4 = xs.shape
    d = d4 // 4
    launch = _kernel_fwd()[0]
    xs, w = _aligned(xs), _aligned(w)  # copied in 16-byte pieces
    hs = torch.empty((t, b, d), dtype=xs.dtype, device=xs.device)
    cs = torch.empty((t, b, d), dtype=torch.float32, device=xs.device)
    acts = torch.empty_like(xs) if save_acts else None
    with torch.cuda.device(xs.device):
        rc = launch(
            xs.data_ptr(), w.data_ptr(), bias.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), mask.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            None if acts is None else acts.data_ptr(), t, b, d,
            _DTYPE_CODES[xs.dtype], cluster,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError('lstm_fwd kernel launch failed: CUDA error %d' % rc)
    LAUNCHES_FWD += 1
    return hs, cs, acts


def _dw_splits(steps, batch, d, device, tile_k):
    """K slices of the dW product: four 64 x 64 output tiles of 4 warps for
    each SM of the card (33 slices of 256 rows at B=128, T=64, D=128, where
    the H100 ran 8 slices in 0.042 ms and 32 in 0.030), none thinner than
    one ``tile_k``-deep step."""
    tiles = math.ceil(d / 64) * math.ceil(4 * d / 64)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(4 * sms // tiles, math.ceil(steps * batch / tile_k)))


def _aligned(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (the
    kernels copy rows to shared memory in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_walk(w, mask, acts, cs, h0, c0, dhs, dcs, cluster=0):
    """The reverse-time walk: (dx, dh0, dc0, db_part), with clusters of
    ``cluster`` CTAs (0: ``walk_cluster``'s choice).  Arguments checked by
    the caller (check_bwd_args)."""
    global LAUNCHES_BWD
    t, b, d4 = acts.shape
    walk, _, rows, _, _, _ = _kernels_bwd()
    w, mask, acts, cs, c0, dhs, dcs = (
        _aligned(x) for x in (w, mask, acts, cs, c0, dhs, dcs))
    dx = torch.empty_like(acts)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    db_part = torch.empty((math.ceil(b / rows), d4), dtype=torch.float32,
                          device=acts.device)
    with torch.cuda.device(acts.device):
        rc = walk(w.data_ptr(), mask.data_ptr(), acts.data_ptr(),
                  cs.data_ptr(), c0.data_ptr(), dhs.data_ptr(),
                  dcs.data_ptr(), dx.data_ptr(), dh0.data_ptr(),
                  dc0.data_ptr(), db_part.data_ptr(), t, b, d4 // 4,
                  _DTYPE_CODES[acts.dtype], cluster,
                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError('lstm_bwd kernel launch failed: CUDA error %d' % rc)
    LAUNCHES_BWD += 1
    return dx, dh0, dc0, db_part


def _launch_dw(hs, h0, dx, db_part):
    """dW [D, 4D] f32 and db [1, 4D] f32 from the walk's dx and db_part."""
    global LAUNCHES_DW
    t, b, d4 = dx.shape
    d = d4 // 4
    dev = dx.device
    _, launch, _, _, tile_k, _ = _kernels_bwd()
    hs, h0 = _aligned(hs), _aligned(h0)
    splits = _dw_splits(t, b, d, dev, tile_k)
    part = torch.empty((splits, d, d4), dtype=torch.float32, device=dev)
    dw = torch.empty((d, d4), dtype=torch.float32, device=dev)
    db = torch.empty((1, d4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = launch(
            hs.data_ptr(), h0.data_ptr(), dx.data_ptr(), db_part.data_ptr(),
            part.data_ptr(), dw.data_ptr(), db.data_ptr(), t, b, d, splits,
            _DTYPE_CODES[dx.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError('lstm_bwd_dw kernel launch failed: CUDA error %d'
                           % rc)
    LAUNCHES_DW += 1
    return dw, db


def _launch_bwd(w, mask, acts, cs, hs, h0, c0, dhs, dcs):
    check_bwd_args(w, mask, acts, cs, hs, h0, c0, dhs, dcs)
    dx, dh0, dc0, db_part = _launch_walk(w, mask, acts, cs, h0, c0, dhs, dcs)
    dw, db = _launch_dw(hs, h0, dx, db_part)
    return dx, dw, db, dh0, dc0


def lstm_fwd_plain(xs, w, bias, h0, c0, mask, save_acts=True):
    """``_fwd_kernel``'s function in plain PyTorch, step by step: (hs in
    h0's dtype, cs f32, acts in w's dtype or None).  Used on CPU tensors and
    as the reference the kernel is held to."""
    d = xs.shape[2] // 4
    wf, bf = w.float(), bias.float().reshape(1, 4 * d)
    h, c = h0, c0.float()
    hs, cs, acts = [], [], []
    for t in range(xs.shape[0]):
        gates = xs[t].float() + h.float() @ wf + bf
        gc, gi, gf, go = torch.split(gates, d, dim=1)
        i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        cand = torch.tanh(gc)
        c_new = f * c + i * cand
        h_new = o * torch.tanh(c_new)
        m = mask[t][:, None]
        h = (m * h_new + (1 - m) * h.float()).to(h0.dtype)
        c = m * c_new + (1 - m) * c
        hs.append(h)
        cs.append(c)
        if save_acts:
            acts.append(torch.cat([cand, i, f, o], dim=1).to(w.dtype))
    return (torch.stack(hs), torch.stack(cs),
            torch.stack(acts) if save_acts else None)


def lstm_bwd_plain(w, mask, acts, cs, hs, h0, c0, dhs, dcs):
    """``_bwd_kernel``'s function in plain PyTorch, walking T in reverse as
    it does: (dx in w's dtype, dW f32, db [1, 4D] f32, dh0 in h0's dtype,
    dc0 f32).  db sums the f32 dgates, dW the dgates rounded to w's dtype."""
    t_steps, b, d4 = acts.shape
    d = d4 // 4
    wf = w.float()
    dh = torch.zeros((b, d), dtype=torch.float32, device=acts.device)
    dc = torch.zeros_like(dh)
    dw = torch.zeros((d, d4), dtype=torch.float32, device=acts.device)
    db = torch.zeros((1, d4), dtype=torch.float32, device=acts.device)
    dx = [None] * t_steps
    for t in reversed(range(t_steps)):
        c_prev = c0.float() if t == 0 else cs[t - 1]
        h_prev = h0 if t == 0 else hs[t - 1]
        cand, i, f, o = torch.split(acts[t].float(), d, dim=1)
        c_new = f * c_prev + i * cand
        tanh_c = torch.tanh(c_new)
        m = mask[t][:, None]
        dh_tot = dhs[t].float() + dh
        dc_tot = dcs[t] + dc
        dh_new = m * dh_tot
        do = dh_new * tanh_c
        dc_new = m * dc_tot + dh_new * o * (1 - tanh_c * tanh_c)
        dgi = dc_new * cand * i * (1 - i)
        dgf = dc_new * c_prev * f * (1 - f)
        dgo = do * o * (1 - o)
        dgc = dc_new * i * (1 - cand * cand)
        dgates = torch.cat([dgc, dgi, dgf, dgo], dim=1)
        dx[t] = dgates.to(w.dtype)
        dg16 = dx[t].float()
        dh = (1 - m) * dh_tot + dg16 @ wf.t()
        dc = (1 - m) * dc_tot + dc_new * f
        dw = dw + h_prev.to(w.dtype).float().t() @ dg16
        db = db + dgates.sum(0, keepdim=True)
    return torch.stack(dx), dw, db, dh.to(h0.dtype), dc


def _on_cpu(name, tensors):
    if any(t is not None and t.is_cuda for t in tensors):
        raise ValueError('%s: the first input is on the CPU but another is '
                         'on a CUDA device' % name)


def lstm_fwd(xs, w, bias, h0, c0, mask, save_acts=True):
    """(hs, cs, acts or None) of the recurrence: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if xs.is_cuda:
        return _launch_fwd(xs, w, bias, h0, c0, mask, save_acts)
    _on_cpu('lstm_fwd', (w, bias, h0, c0, mask))
    return lstm_fwd_plain(xs, w, bias, h0, c0, mask, save_acts)


def lstm_bwd(w, mask, acts, cs, hs, h0, c0, dhs, dcs):
    """(dx, dW f32, db f32, dh0, dc0) from the forward's saved values and the
    output gradients dhs (hs's dtype) and dcs (f32): the walk and dW kernels
    for CUDA tensors, the plain version for CPU tensors."""
    if acts.is_cuda:
        return _launch_bwd(w, mask, acts, cs, hs, h0, c0, dhs, dcs)
    _on_cpu('lstm_bwd', (w, mask, cs, hs, h0, c0, dhs, dcs))
    return lstm_bwd_plain(w, mask, acts, cs, hs, h0, c0, dhs, dcs)


class LSTMCore(torch.autograd.Function):
    """(hs, cs, acts) = the recurrence over (xs, w16, bias, h0, c0, mask);
    gradients flow to all but mask through the backward kernels.

    The ``setup_context`` form, the one ``torch.func`` transforms accept:
    acts is an output (marked non-differentiable) so that it can be saved.
    w16 is w already cast to xs's dtype, as in ``_lstm_core``."""

    @staticmethod
    def forward(xs, w16, bias, h0, c0, mask):
        return lstm_fwd(xs, w16, bias, h0, c0, mask, save_acts=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, w16, _, h0, c0, mask = inputs
        hs, cs, acts = output
        ctx.mark_non_differentiable(acts)
        ctx.save_for_backward(w16, mask, acts, cs, hs, h0, c0)

    @staticmethod
    def backward(ctx, dhs, dcs, _dacts):
        w16, mask, acts, cs, hs, h0, c0, dhs, dcs = (
            unwrapped(t) for t in ctx.saved_tensors + (dhs, dcs))
        dx, dw, db, dh0, dc0 = lstm_bwd(
            w16, mask, acts, cs, hs, h0, c0,
            dhs.to(hs.dtype).contiguous(), dcs.float().contiguous())
        return dx, dw.to(w16.dtype), db, dh0, dc0, None


def lstm_fused_tm(xs, w, bias, h0, c0, mask=None):
    """Time-major fused LSTM, the JAX package's signature: xs [T, B, 4D]
    pre-projected gates, w [D, 4D], bias [1, 4D], h0 [B, D] (x's dtype), c0
    [B, D] f32, mask [T, B] or None.  Returns (hs [T, B, D] in h0's dtype,
    cs [T, B, D] f32).  Differentiable in xs, w, bias, h0 and c0."""
    t, b, d4 = xs.shape
    if mask is None:
        mask = torch.ones((t, b), dtype=torch.float32, device=xs.device)
    mask = mask.to(torch.float32).contiguous()
    w16 = w.to(xs.dtype).contiguous()
    bias = bias.to(torch.float32).reshape(1, d4).contiguous()
    args = (xs.contiguous(), w16, bias, h0.contiguous(),
            c0.to(torch.float32).contiguous(), mask)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args[:5]):
        hs, cs, _ = LSTMCore.apply(*args)
    else:
        # no gradient asked for: skip writing the [T, B, 4D] activations
        hs, cs, _ = lstm_fwd(*args, save_acts=False)
    return hs, cs
