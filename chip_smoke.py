#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Phases, in order; any failure exits non-zero and prints no result line:

1. device: a CUDA card is required; prints its name and power limit (as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them) and turns TF32 off for matmuls and cuDNN, so f32 means f32;
2. build: compiles the port's two CUDA libraries from
   ``paddle_tpu_torch/csrc`` (one ``nvcc`` each, started together);
3. kernel vs plain: the forward kernel, then the dQ and dK/dV kernels,
   against their plain PyTorch versions on the card, over causal/non-causal,
   with/without lengths (0, partial, full), self and cross attention, a
   ragged Lq, every supported head_dim, f32 and bf16;
4. serving: Transformer-base at full width (6+6 layers, 8 heads, d_model
   512, d_ff 2048, vocab 30000, seq 256; random weights from a seed) serves
   four requests of 16 x 256 tokens through ``Executor.run`` on
   ``CUDAPlace(0)``; then one 2 x 256 batch runs on the card and on
   ``CPUPlace()`` (the plain versions) with the same weights and the two are
   compared;
5. training: the same model's training program (append_backward + Adam at
   lr 1e-3) takes five steps of 16 x 256 tokens on one fixed batch; the loss
   must fall at every step; then the card's state (parameters, moments,
   beta powers, learning rate) is handed to a ``CPUPlace()`` scope and one
   2 x 256 step runs on each, comparing loss, gradients and updated
   parameters;
6. times: each kernel, its plain version and the one PyTorch call computing
   the same function, at the slice's shape (CUDA events, median), printed
   as one ``{"kernels": [...]}`` JSON line;
7. the last line: ``{"ok": true, "device": {...}}``.

Every launch counter is set to 0 just before the serving requests and just
before the training steps, and read just after each.

It imports nothing of JAX or of the JAX package ``paddle_tpu``.
"""

import concurrent.futures
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
TRAIN_STEPS = 5
LR = 1e-3
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# card vs CPU on the whole 12-layer model in f32: summation order differs
# in every matmul and reduction
SLICE_RTOL, SLICE_ATOL = 1e-3, 1e-7
# one training step, card vs CPU.  Gradients: f32 sums in another order
# through 12 layers and back, with cancellation in the softmax and layer-norm
# backward, so a parameter's error scales with the activations' gradients
# more than with its own.  Each parameter's max|dg| must stay within
# GRAD_RTOL of its own max|g| plus GRAD_ATOL of the largest max|g| in the
# model (after a few steps on one batch some attention projections' grads
# fall to ~1e-12, pure rounding noise on both sides); the norm of all
# gradients' differences must stay within GRAD_NORM_TOL of the norm of all
# gradients.  Updated parameters: Adam divides by sqrt(m2) + eps, so where a
# gradient is near 0 a change of summation order can move the update by up
# to about lr; elsewhere it moves far less than PARAM_ATOL.  So every element
# is held within LR of the CPU, and at most PARAM_FRAC of the elements may
# differ by more than PARAM_ATOL.
GRAD_RTOL, GRAD_ATOL, GRAD_NORM_TOL = 1e-2, 1e-6, 1e-4
PARAM_ATOL, PARAM_FRAC = 1e-6, 1e-4

LIBRARIES = ('flash_attention_fwd', 'flash_attention_bwd')


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

    def timed(name):
        t0 = time.perf_counter()
        path, log = _build.build(name)
        return path, log, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = list(pool.map(timed, LIBRARIES))
    for name, (path, log, seconds) in zip(LIBRARIES, built):
        print('build: %s -> %s' % (name, os.path.relpath(path, REPO)))
        for line in (log or '').splitlines():
            if 'Function properties' in line or 'registers' in line or \
                    'spill' in line:
                print('  ptxas: ' + line.strip())
        print('build: %s %.1f s%s' % (name, seconds, '' if log is not None
                                      else ' (previous build reused)'))
    print('build: both libraries %.1f s' % (time.perf_counter() - t0),
          flush=True)


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


def phase_bwd_vs_plain():
    """dQ, dK, dV of the kernels against flash_attention_bwd_plain on the
    same (q, k, v, O, LSE, dO), over the forward's grid of cases."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    b, h = 4, 8
    worst = {(dt, name): 0.0 for dt in TOL for name in ('dq', 'dk', 'dv')}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in fa.SUPPORTED_HEAD_DIMS:
            for lq, lk in ((256, 256), (256, 200), (200, 200)):
                for causal in (False, True):
                    for with_lens in (False, True):
                        q, k, v = _qkv(b, lq, lk, h, d, dtype, SEED + 500 + n)
                        do = _qkv(b, lq, lq, h, d, dtype, SEED + 900 + n)[0]
                        lens = (torch.tensor([0, 37, lk - 1, lk],
                                             dtype=torch.int32, device='cuda')
                                if with_lens else None)
                        o, lse = fa.flash_attention_plain(
                            q, k, v, causal=causal, seq_lengths=lens)
                        got = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                     causal=causal,
                                                     seq_lengths=lens)
                        want = fa.flash_attention_bwd_plain(
                            q, k, v, o, lse, do, causal=causal,
                            seq_lengths=lens)
                        torch.cuda.synchronize()
                        case = ('%s D=%d Lq=%d Lk=%d causal=%s lens=%s' %
                                (str(dtype)[6:], d, lq, lk, causal,
                                 with_lens))
                        errs = []
                        for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
                            scale = max(1.0, w.float().abs().max().item())
                            err = (g.float() - w.float()).abs().max().item()
                            check(err <= TOL[dtype] * scale,
                                  'backward kernel disagrees with plain: %s: '
                                  'max|%s| err %g > %g * %g' %
                                  (case, name, err, TOL[dtype], scale))
                            worst[dtype, name] = max(worst[dtype, name], err)
                            errs.append(err)
                        n += 1
                        print('bwd vs plain: %-52s max|ddQ|=%.3g max|ddK|=%.3g'
                              ' max|ddV|=%.3g' % ((case, ) + tuple(errs)))
    for dtype in TOL:
        print('bwd vs plain: %s worst max|ddQ| %.3g, max|ddK| %.3g, max|ddV| '
              '%.3g (tol %g * max(1, max|plain|))' %
              ((str(dtype)[6:], ) +
               tuple(worst[dtype, g] for g in ('dq', 'dk', 'dv')) +
               (TOL[dtype], )))
    print('bwd vs plain: %d cases agree' % n, flush=True)
    return {'dq': worst[torch.float32, 'dq'],
            'dkv': max(worst[torch.float32, 'dk'],
                       worst[torch.float32, 'dv'])}


def build_model():
    """Transformer-base at full width, training program included, with its
    startup run on the card."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer
    cfg = TRANSFORMER_BASE
    with fluid.unique_name.guard():
        model = transformer.build(lr=LR, **cfg)
    model['startup'].random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(model['startup'], scope=scope)
    torch.cuda.synchronize()
    n_params = sum(math.prod(p.shape)
                   for p in model['test'].all_parameters())
    print('model: Transformer-base %s, %d parameters, Adam lr %g, startup '
          '%.2f s' % (cfg, n_params, LR, time.perf_counter() - t0),
          flush=True)
    return model, scope, exe


def _counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    return {'fwd': fa.LAUNCHES, 'dq': fa.LAUNCHES_DQ, 'dkv': fa.LAUNCHES_DKV}


def _zero_counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    fa.LAUNCHES = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0


def phase_slice(card, model, scope, exe):
    import paddle_tpu_torch.fluid as fluid
    cfg = TRANSFORMER_BASE
    seq, vocab = cfg['max_len'], cfg['trg_vocab']
    rng = np.random.RandomState(SEED)
    ids = lambda b: rng.randint(1, vocab, size=(b, seq)).astype('int64')
    requests = [{name: ids(BATCH) for name in model['feeds']}
                for _ in range(REQUESTS)]
    fetch = [model['loss'], model['prediction']]
    per_request = 3 * cfg['n_layer']
    walls = []
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # every launch counter to 0 just before the serving path
    for i, feed in enumerate(requests):
        before = _counts()['fwd']
        t0 = time.perf_counter()
        loss, pred = exe.run(model['test'], feed=feed, fetch_list=fetch,
                             scope=scope)
        walls.append(time.perf_counter() - t0)
        grew = _counts()['fwd'] - before
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
    launches = _counts()
    check(launches['dq'] == 0 and launches['dkv'] == 0,
          'serving launched backward kernels: %s' % launches)
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    tokens = BATCH * seq
    print('slice: %d requests, %d flash launches (%d per request); steady '
          'request wall %.4f s (median of requests 2-%d; request 1 includes '
          'first-call set-up), %.0f target tokens/s (batch %d x seq %d, '
          'loss and full prediction fetched to the host); peak device memory '
          '%.1f MiB [%s]' % (REQUESTS, launches['fwd'], per_request, steady,
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


def phase_train(card, model, scope, exe):
    """TRAIN_STEPS Adam steps of BATCH x seq on one fixed batch."""
    cfg = TRANSFORMER_BASE
    seq, vocab = cfg['max_len'], cfg['trg_vocab']
    rng = np.random.RandomState(SEED + 1)
    feed = {name: rng.randint(1, vocab, size=(BATCH, seq)).astype('int64')
            for name in model['feeds']}
    n_flash = 3 * cfg['n_layer']
    # the forward pass launches the forward kernel once per flash_attention
    # op; each op's generic grad replays its forward (one more forward
    # launch, eagerly: nothing merges it with the first) and then runs the
    # dQ and dK/dV kernels once each
    per_step = {'fwd': 2 * n_flash, 'dq': n_flash, 'dkv': n_flash}
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # every launch counter to 0 just before the training path
    for step in range(TRAIN_STEPS):
        before = _counts()
        t0 = time.perf_counter()
        loss, = exe.run(model['main'], feed=feed, fetch_list=[model['loss']],
                        scope=scope)
        walls.append(time.perf_counter() - t0)
        after = _counts()
        grew = {k: after[k] - before[k] for k in after}
        check(grew == per_step, 'training step %d launched %s, expected %s' %
              (step + 1, grew, per_step))
        check(loss.shape == (1, ) and np.isfinite(loss).all(),
              'training step %d: loss %s is not finite' % (step + 1, loss))
        losses.append(float(loss[0]))
        print('train: step %d wall %.4f s, loss %.6f, launches %s [%s]' %
              (step + 1, walls[-1], losses[-1], grew, card), flush=True)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(b < a for a, b in zip(losses, losses[1:])),
          'training loss did not fall at every step: %s' % losses)
    steady = statistics.median(walls[1:])
    print('train: %d Adam steps (lr %g) on one %d x %d batch, loss %.6f -> '
          '%.6f, falling at every step; launches %s (%s per step); steady '
          'step wall %.4f s (median of steps 2-%d; step 1 includes first-call '
          'set-up), %.0f target tokens/s; peak device memory %.1f MiB [%s]' %
          (TRAIN_STEPS, LR, BATCH, seq, losses[0], losses[-1], launches,
           per_step, steady, TRAIN_STEPS, BATCH * seq / steady, peak / 2**20,
           card), flush=True)
    return launches


def phase_train_card_vs_cpu(card, model, scope, exe):
    """One training step on the card and on the CPU from the same state."""
    import paddle_tpu_torch.fluid as fluid
    main = model['main']
    seq, vocab = TRANSFORMER_BASE['max_len'], TRANSFORMER_BASE['trg_vocab']
    state = [v.name for v in main.list_vars() if v.persistable]
    cpu_scope = fluid.Scope()
    fluid.persistables_from_numpy(
        main, {n: scope.find_var(n).value().cpu().numpy() for n in state},
        scope=cpu_scope, place=fluid.CPUPlace())
    rng = np.random.RandomState(SEED + 2)
    feed = {name: rng.randint(1, vocab, size=(2, seq)).astype('int64')
            for name in model['feeds']}
    params = [p.name for p in main.all_parameters()]
    fetch = [model['loss'].name] + [p + '@GRAD' for p in params]
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    t0 = time.perf_counter()
    want = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                                fetch_list=fetch,
                                                scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    loss_rel = float(abs(got[0][0] - want[0][0]) / abs(want[0][0]))
    check(loss_rel < SLICE_RTOL, 'training step, card vs CPU: loss %.7f vs '
          '%.7f (rel %g)' % (got[0][0], want[0][0], loss_rel))
    top = max(float(np.abs(w).max()) for w in want[1:])
    grad_err, diff_sq, norm_sq = 0.0, 0.0, 0.0
    for name, g, w in zip(params, got[1:], want[1:]):
        err = float(np.abs(g - w).max())
        own = float(np.abs(w).max())
        check(err <= GRAD_RTOL * own + GRAD_ATOL * top,
              'training step, card vs CPU: %s@GRAD max|dg| %g > %g * %g + '
              '%g * %g' % (name, err, GRAD_RTOL, own, GRAD_ATOL, top))
        grad_err = max(grad_err, err / (GRAD_RTOL * own + GRAD_ATOL * top))
        diff_sq += float(np.square(g - w, dtype=np.float64).sum())
        norm_sq += float(np.square(w, dtype=np.float64).sum())
    norm_err = math.sqrt(diff_sq / norm_sq)
    check(norm_err <= GRAD_NORM_TOL, 'training step, card vs CPU: |dg| / |g| '
          'over all gradients %g (tol %g)' % (norm_err, GRAD_NORM_TOL))
    worst, n_far, n_all = 0.0, 0, 0
    for name in params:
        dp = np.abs(scope.find_var(name).value().cpu().numpy() -
                    cpu_scope.find_var(name).value().numpy())
        worst = max(worst, float(dp.max()))
        n_far += int((dp > PARAM_ATOL).sum())
        n_all += dp.size
    check(worst <= LR and n_far <= PARAM_FRAC * n_all,
          'training step, card vs CPU: updated parameters differ by up to %g '
          '(limit lr %g), %d of %d elements by more than %g (limit %g of '
          'them)' % (worst, LR, n_far, n_all, PARAM_ATOL, PARAM_FRAC))
    print('train: card vs CPU, one step on 2 x %d from the same state: loss '
          '%.6f vs %.6f (rel %.2g, tol %g); %d gradients: the worst max|dg| '
          'is %.3g of its allowance (%g of its max|g| + %g of the largest, '
          '%.3g), |dg| / |g| over all %.3g (tol %g); updated parameters: '
          'max|dp| %.3g (limit lr %g), %d of %d elements differ by more than '
          '%g (limit %g of them); CPU step %.2f s [%s]' %
          (seq, got[0][0], want[0][0], loss_rel, SLICE_RTOL, len(params),
           grad_err, GRAD_RTOL, GRAD_ATOL, top, norm_err, GRAD_NORM_TOL,
           worst, LR, n_far, n_all, PARAM_ATOL, PARAM_FRAC, cpu_s, card),
          flush=True)


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


def phase_times(card, launches, fwd_err, bwd_err):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    b, h, seq = BATCH, TRANSFORMER_BASE['n_head'], TRANSFORMER_BASE['max_len']
    d = TRANSFORMER_BASE['d_model'] // h
    scale = d**-0.5
    q, k, v = _qkv(b, seq, seq, h, d, torch.float32, SEED)
    do = _qkv(b, seq, seq, h, d, torch.float32, SEED + 7)[0]
    err = {'fwd': fwd_err, 'dq': bwd_err['dq'], 'dkv': bwd_err['dkv']}
    for causal in (False, True):  # the slice's encoder and decoder calls
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        pdq, pdk, pdv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     causal=causal)
        torch.cuda.synchronize()
        for name, g, w in (('O', o, po), ('LSE', lse, plse), ('dQ', dq, pdq),
                           ('dK', dk, pdk), ('dV', dv, pdv)):
            tol = 1e-4 * max(1.0, w.abs().max().item())
            check((g - w).abs().max().item() <= tol,
                  'kernel disagrees with plain at the slice shape (causal=%s):'
                  ' %s' % (causal, name))
        err['fwd'] = max(err['fwd'], (o - po).abs().max().item())
        err['dq'] = max(err['dq'], (dq - pdq).abs().max().item())
        err['dkv'] = max(err['dkv'], (dk - pdk).abs().max().item(),
                         (dv - pdv).abs().max().item())
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.bwd_delta(o, do)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = {
        'fwd': _time_ms(lambda: fa.flash_attention_fwd(q, k, v)),
        'dq': _time_ms(lambda: fa._launch_dq(q, k, v, do, lse, delta, None,
                                             False, scale)),
        'dkv': _time_ms(lambda: fa._launch_dkv(q, k, v, do, lse, delta, None,
                                               False, scale)),
    }
    delta_ms = _time_ms(lambda: fa.bwd_delta(o, do))
    plain_ms = {'fwd': _time_ms(lambda: fa.flash_attention_plain(q, k, v))}
    # the plain backward computes dQ, dK and dV in one call: both backward
    # rows carry its time
    plain_ms['dq'] = plain_ms['dkv'] = _time_ms(
        lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do))
    library_ms = {'fwd': _time_ms(lambda: sdpa(qt, kt, vt))}
    # SDPA's backward alone: one call gives dQ, dK and dV, so both backward
    # rows carry this combined time
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    out = sdpa(qg, kg, vg)
    dout = do.transpose(1, 2).contiguous()
    library_ms['dq'] = library_ms['dkv'] = _time_ms(
        lambda: torch.autograd.grad(out, (qg, kg, vg), dout,
                                    retain_graph=True))
    # least time of each call: its products (2 FLOP per multiply-add, every
    # (row, column) pair unmasked here) at the f32 peak, against its inputs
    # read once and its outputs written once at the HBM rate
    elems = b * seq * h * d  # one [B, L, H, D] tensor
    rows = b * seq * h       # one [B, L, H] f32 tensor (LSE, delta)
    pairs = b * h * seq * seq * d
    work = {
        'fwd': (4.0 * pairs, 4 * (4 * elems + rows)),        # q k v -> O LSE
        'dq': (6.0 * pairs, 4 * (5 * elems + 2 * rows)),     # +dO LSE delta
        'dkv': (8.0 * pairs, 4 * (6 * elems + 2 * rows)),    # -> dK dV
    }
    sources = {
        'fwd': ('flash_attention_fwd', 'flash_attention_fwd.cu', 37),
        'dq': ('flash_attention_dq', 'flash_attention_bwd.cu', 87),
        'dkv': ('flash_attention_dkv', 'flash_attention_bwd.cu', 130),
    }
    kernels = []
    for key in ('fwd', 'dq', 'dkv'):
        flops, nbytes = work[key]
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        bound_ms = 1e3 * max(t_ops, t_bytes)
        name, src, line = sources[key]
        print('times: %s f32 B=%d Lq=Lk=%d H=%d D=%d non-causal: kernel %.4f '
              'ms, plain %.4f ms, library %.4f ms, bound %.4f ms (%.3g GFLOP '
              'at 67 TFLOP/s f32, %.3g MB at 3.35 TB/s) [%s]' %
              (name, b, seq, h, d, ms[key], plain_ms[key], library_ms[key],
               bound_ms, flops / 1e9, nbytes / 1e6, card), flush=True)
        kernels.append({
            'name': name,
            'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/' + src,
            'replaces': 'paddle_tpu/ops/pallas/flash_attention.py:%d' % line,
            'launches': launches['train'][key],
            'launches_by_path': {p: launches[p][key] for p in launches},
            'max_abs_err': err[key],
            'ms': ms[key],
            'plain_ms': plain_ms[key],
            'bound_ms': bound_ms,
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
            'library_ms': library_ms[key],
        })
    print('times: backward at the slice shape: dQ %.4f + dK/dV %.4f + delta '
          '%.4f = %.4f ms against SDPA backward (dQ, dK, dV in one call) '
          '%.4f ms; plain backward %.4f ms [%s]' %
          (ms['dq'], ms['dkv'], delta_ms, ms['dq'] + ms['dkv'] + delta_ms,
           library_ms['dq'], plain_ms['dq'], card), flush=True)
    return kernels


def main():
    card = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    fwd_err = phase_kernel_vs_plain()
    bwd_err = phase_bwd_vs_plain()
    model, scope, exe = build_model()
    launches = {'serve': phase_slice(card, model, scope, exe),
                'train': phase_train(card, model, scope, exe)}
    phase_train_card_vs_cpu(card, model, scope, exe)
    kernels = phase_times(card, launches, fwd_err, bwd_err)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
