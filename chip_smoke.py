#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Phases, in order; any failure exits non-zero and prints no result line:

1. device: a CUDA card is required; prints its name and power limit (as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them) and turns TF32 off for matmuls and cuDNN, so f32 means f32;
2. build: compiles the port's CUDA kernel from ``paddle_tpu_torch/csrc``;
3. kernel vs plain: each kernel against its plain PyTorch version on the card,
   over causal/non-causal, with/without lengths (0, partial, full), self and
   cross attention, a ragged Lq, every supported head_dim, f32 and bf16;
4. slice: Transformer-base at full width (6+6 layers, 8 heads, d_model 512,
   d_ff 2048, vocab 30000, seq 256; random weights from a seed) serves four
   requests of 16 x 256 tokens through ``Executor.run`` on ``CUDAPlace(0)``,
   with every launch counter set to 0 just before and read just after; then
   one 2 x 256 batch runs on the card and on ``CPUPlace()`` (the plain
   versions) with the same weights and the two are compared;
5. times: each kernel, its plain version and the one PyTorch call computing
   the same function, at the slice's shape (CUDA events, median), printed
   as one ``{"kernels": [...]}`` JSON line;
6. the last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package ``paddle_tpu``.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# H100 SXM data-sheet peaks (dense): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

TRANSFORMER_BASE = dict(src_vocab=30000, trg_vocab=30000, max_len=256,
                        n_layer=6, n_head=8, d_model=512, d_ff=2048)
BATCH = 16
REQUESTS = 4
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# card vs CPU on the whole 12-layer model in f32: summation order differs
# in every matmul and reduction
SLICE_RTOL, SLICE_ATOL = 1e-3, 1e-7


def fail(msg):
    print('chip_smoke: FAILED: %s' % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def phase_device():
    check(torch.cuda.is_available(), 'torch.cuda.is_available() is False: '
          'this script runs on a CUDA card only')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader',
         '-i', str(torch.cuda.current_device())],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          'nvidia-smi failed: %s' % smi.stderr)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print('device: %s (torch %s, CUDA %s); TF32 off: matmul.allow_tf32=%s '
          'cudnn.allow_tf32=%s' % (torch.cuda.get_device_name(0),
                                   torch.__version__, torch.version.cuda,
                                   torch.backends.cuda.matmul.allow_tf32,
                                   torch.backends.cudnn.allow_tf32),
          flush=True)
    return card


def phase_build():
    from paddle_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    path, log = _build.build('flash_attention_fwd')
    seconds = time.perf_counter() - t0
    print('build: flash_attention_fwd -> %s' % os.path.relpath(path, REPO))
    for line in (log or '').splitlines():
        if 'registers' in line or 'spill' in line:
            print('  ptxas: ' + line.strip())
    print('build: %.1f s%s' % (seconds, '' if log is not None else
                               ' (previous build reused)'), flush=True)


def _qkv(b, lq, lk, h, d, dtype, seed):
    g = torch.Generator(device='cuda')
    g.manual_seed(seed)
    mk = lambda l: torch.randn(b, l, h, d, device='cuda', generator=g).to(
        dtype)
    return mk(lq), mk(lk), mk(lk)


def phase_kernel_vs_plain():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    b, h = 4, 8
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in fa.SUPPORTED_HEAD_DIMS:
            for lq, lk in ((256, 256), (256, 200), (200, 200)):
                for causal in (False, True):
                    for with_lens in (False, True):
                        q, k, v = _qkv(b, lq, lk, h, d, dtype, SEED + n)
                        lens = (torch.tensor([0, 37, lk - 1, lk],
                                             dtype=torch.int32, device='cuda')
                                if with_lens else None)
                        o, lse = fa.flash_attention_fwd(
                            q, k, v, causal=causal, seq_lengths=lens)
                        po, plse = fa.flash_attention_plain(
                            q, k, v, causal=causal, seq_lengths=lens)
                        torch.cuda.synchronize()
                        tol = TOL[dtype]
                        err_o = (o.float() - po.float()).abs().max().item()
                        err_l = (lse - plse).abs().max().item()
                        case = ('%s D=%d Lq=%d Lk=%d causal=%s lens=%s' %
                                (str(dtype)[6:], d, lq, lk, causal,
                                 with_lens))
                        check(torch.allclose(o.float(), po.float(), rtol=tol,
                                             atol=tol) and
                              torch.allclose(lse, plse, rtol=tol, atol=tol),
                              'kernel disagrees with plain: %s: max|dO|=%g '
                              'max|dLSE|=%g (tol %g)' % (case, err_o, err_l,
                                                         tol))
                        worst[dtype] = max(worst[dtype], err_o)
                        n += 1
                        print('kernel vs plain: %-52s max|dO|=%.3g '
                              'max|dLSE|=%.3g' % (case, err_o, err_l))
    print('kernel vs plain: %d cases agree; worst max|dO| f32 %.3g (tol '
          '1e-4), bf16 %.3g (tol 2e-2)' % (n, worst[torch.float32],
                                          worst[torch.bfloat16]), flush=True)
    return worst[torch.float32]


def phase_slice(card):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    cfg = TRANSFORMER_BASE
    seq, vocab = cfg['max_len'], cfg['trg_vocab']
    with fluid.unique_name.guard():
        model = transformer.build(**cfg)
    model['startup'].random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(model['startup'], scope=scope)
    torch.cuda.synchronize()
    n_params = sum(math.prod(p.shape)
                   for p in model['test'].all_parameters())
    print('slice: Transformer-base %s, %d parameters, startup %.2f s' %
          (cfg, n_params, time.perf_counter() - t0), flush=True)

    rng = np.random.RandomState(SEED)
    ids = lambda b: rng.randint(1, vocab, size=(b, seq)).astype('int64')
    requests = [{name: ids(BATCH) for name in model['feeds']}
                for _ in range(REQUESTS)]
    fetch = [model['loss'], model['prediction']]
    per_request = 3 * cfg['n_layer']
    walls = []
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # every launch counter to 0 just before the main path
    for i, feed in enumerate(requests):
        before = fa.LAUNCHES
        t0 = time.perf_counter()
        loss, pred = exe.run(model['test'], feed=feed, fetch_list=fetch,
                             scope=scope)
        walls.append(time.perf_counter() - t0)
        grew = fa.LAUNCHES - before
        check(grew == per_request, 'request %d launched the flash kernel %d '
              'times, expected %d' % (i, grew, per_request))
        check(loss.shape == (1, ) and np.isfinite(loss).all(),
              'request %d: loss %s is not finite' % (i, loss))
        check(pred.shape == (BATCH, seq, vocab) and np.isfinite(pred).all(),
              'request %d: prediction shape %s or values not finite' %
              (i, pred.shape))
        row_err = float(np.abs(pred.sum(-1, dtype=np.float64) - 1.0).max())
        check(row_err < 1e-4, 'request %d: prediction rows sum to 1 +- %g' %
              (i, row_err))
        print('slice: request %d wall %.4f s, loss %.6f, %d flash launches, '
              'max|row sum - 1| %.2g [%s]' % (i + 1, walls[-1], loss[0], grew,
                                             row_err, card), flush=True)
    launches = fa.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    tokens = BATCH * seq
    print('slice: %d requests, %d flash launches (%d per request); steady '
          'request wall %.4f s (median of requests 2-%d; request 1 includes '
          'first-call set-up), %.0f target tokens/s (batch %d x seq %d, '
          'loss and full prediction fetched to the host); peak device memory '
          '%.1f MiB [%s]' % (REQUESTS, launches, per_request, steady,
                             REQUESTS, tokens / steady, BATCH, seq,
                             peak / 2**20, card), flush=True)

    # the same weights and one 2 x 256 batch on the card and on the CPU
    small = {name: ids(2) for name in model['feeds']}
    gloss, gpred = exe.run(model['test'], feed=small, fetch_list=fetch,
                           scope=scope)
    cpu_scope = fluid.Scope()
    fluid.params_from_numpy(
        model['test'],
        {p.name: scope.find_var(p.name).value().cpu().numpy()
         for p in model['test'].all_parameters()},
        scope=cpu_scope, place=fluid.CPUPlace())
    t0 = time.perf_counter()
    closs, cpred = fluid.Executor(fluid.CPUPlace()).run(
        model['test'], feed=small, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    pred_err = float(np.abs(gpred - cpred).max())
    pred_rel = float((np.abs(gpred - cpred) /
                      np.maximum(np.abs(cpred), 1e-30)).max())
    loss_rel = float(abs(gloss[0] - closs[0]) / abs(closs[0]))
    check(np.allclose(gpred, cpred, rtol=SLICE_RTOL, atol=SLICE_ATOL) and
          loss_rel < SLICE_RTOL,
          'card and CPU disagree on the slice: max|dpred| %g (max rel %g), '
          'loss rel %g (rtol %g, atol %g)' % (pred_err, pred_rel, loss_rel,
                                              SLICE_RTOL, SLICE_ATOL))
    print('slice: card vs CPU on 2 x %d: loss %.6f vs %.6f (rel %.2g), '
          'max|dpred| %.3g, max rel %.3g (rtol %g, atol %g); CPU run %.2f s'
          % (seq, gloss[0], closs[0], loss_rel, pred_err, pred_rel,
             SLICE_RTOL, SLICE_ATOL, cpu_s), flush=True)
    return launches


def _time_ms(fn, launches_per_sample=10, samples=20, warmup=5):
    """Median device time of one call (CUDA events around back-to-back
    launches, so host overhead between launches is hidden)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches_per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches_per_sample)
    return statistics.median(times)


def phase_times(card, launches, worst_err):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    b, h, seq = BATCH, TRANSFORMER_BASE['n_head'], TRANSFORMER_BASE['max_len']
    d = TRANSFORMER_BASE['d_model'] // h
    q, k, v = _qkv(b, seq, seq, h, d, torch.float32, SEED)
    err = 0.0
    for causal in (False, True):  # the slice's encoder and decoder calls
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(torch.allclose(o, po, rtol=1e-4, atol=1e-4) and
              torch.allclose(lse, plse, rtol=1e-4, atol=1e-4),
              'kernel disagrees with plain at the slice shape (causal=%s)'
              % causal)
        err = max(err, (o - po).abs().max().item())
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v))
    plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v))
    library_ms = _time_ms(lambda: sdpa(qt, kt, vt))
    # least time for this call: its two products (2 FLOP per multiply-add,
    # every (row, column) pair unmasked here) at the f32 peak, against
    # q, k, v read once and O, LSE written once at the HBM rate
    flops = 4.0 * b * h * seq * seq * d
    nbytes = 4 * (4 * b * seq * h * d) + 4 * b * seq * h
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    print('times: flash_attention_fwd f32 B=%d Lq=Lk=%d H=%d D=%d '
          'non-causal: kernel %.4f ms, plain %.4f ms, sdpa %.4f ms, bound '
          '%.4f ms (%.3g GFLOP at 67 TFLOP/s f32, %.3g MB at 3.35 TB/s) [%s]'
          % (b, seq, h, d, ms, plain_ms, library_ms, bound_ms, flops / 1e9,
             nbytes / 1e6, card), flush=True)
    return [{
        'name': 'flash_attention_fwd',
        'route': 'cuda',
        'source': 'paddle_tpu_torch/csrc/flash_attention_fwd.cu',
        'replaces': 'paddle_tpu/ops/pallas/flash_attention.py:37',
        'launches': launches,
        'max_abs_err': max(worst_err, err),
        'ms': ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
        'library_ms': library_ms,
    }]


def main():
    card = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    worst_err = phase_kernel_vs_plain()
    launches = phase_slice(card)
    kernels = phase_times(card, launches, worst_err)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
