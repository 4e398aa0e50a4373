#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]   # from the repository root

Weights, token ids, lengths and labels are drawn from ``--seed``.

Phases, in order; any failure exits non-zero and prints no result line:

1. device: a CUDA card is required; prints its name and power limit (as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them) and turns TF32 off for matmuls and cuDNN, so f32 means f32;
2. build: compiles the port's four CUDA libraries from
   ``paddle_tpu_torch/csrc`` (one ``nvcc`` each, all started together),
   prints ptxas's register and spill lines, counts the HMMA (tensor-core)
   instructions in the SASS (``cuobjdump -sass``) of the flash-attention
   forward library and of the LSTM backward library (its dW kernel) and
   fails if either has none, if an f32 instantiation of the flash forward
   spills, or if an f32 instantiation of the LSTM walk spills (every walk
   and dW instantiation's registers and spills printed);
3. kernel vs plain: the flash-attention forward kernel, then its dQ and
   dK/dV kernels, against their plain PyTorch versions on the card, over
   causal/non-causal, with/without lengths (0, partial, full), self and cross
   attention, a ragged Lq, every supported head_dim, f32 and bf16; then the
   LSTM forward kernel (with and without the saved activations), its
   backward walk and its dW kernel against theirs, over f32/bf16, D 32, 64,
   128, 256, 512, B 128 and 13, T 64 and 1, full and ragged lengths (0 and
   T among them), nonzero h0/c0, each case with the walk's cluster size;
   then the walk at every cluster size against the plain version and,
   bitwise, against the size the library picks;
4. Transformer serving: Transformer-base at full width (6+6 layers, 8 heads,
   d_model 512, d_ff 2048, vocab 30000, seq 256; random weights from a seed)
   serves four requests of 16 x 256 tokens through ``Executor.run`` on
   ``CUDAPlace(0)``; then one 2 x 256 batch runs on the card and on
   ``CPUPlace()`` (the plain versions) with the same weights and the two are
   compared;
5. Transformer training: the same model's training program (append_backward
   + Adam at lr 1e-3) takes five steps of 16 x 256 tokens on one fixed batch;
   the loss must fall at every step; then the card's state (parameters,
   moments, beta powers, learning rate) is handed to a ``CPUPlace()`` scope
   and one 2 x 256 step runs on each, comparing loss, gradients and updated
   parameters;
6. stacked-LSTM serving: the IMDB stacked-LSTM model at its published widths
   (dictionary 5149, embedding 128, hidden 128, 3 LSTM layers, 2 classes;
   random weights from a seed) in two forms, as built (peepholes: the scan
   path) and the same net without peepholes (the LSTM kernels), serves four
   LoD requests of 128 rows with lengths in [1, 64]; each form's 8-row
   request is compared with ``CPUPlace()``;
7. stacked-LSTM training: five Adam steps (lr 0.002) of the kernel form on
   one 128-row batch with exact launch counts and a falling loss; one step
   of each form from the same state on the card and on the CPU;
8. times: each kernel, its plain version and the one PyTorch call computing
   the same function, at each slice's shape (CUDA events, median), the
   kernel and the library call also by their device time alone under
   ``torch.profiler`` (``device_ms``, ``library_device_ms``; the names of
   the kernels SDPA ran are printed), each kernel's bound (operations at
   the 3xTF32 tensor-core rate, bytes at the HBM rate; the same with the
   f32 FMA rate is printed beside it), the LSTM walk's device time at each
   cluster size and at bf16, and the ``lstm`` op's scan and kernel paths,
   printed as one ``{"kernels": [...]}`` JSON line;
9. the last line: ``{"ok": true, "device": {...}}``.

Every launch counter is set to 0 just before each serving and each training
path, and read just after it.

It imports nothing of JAX or of the JAX package ``paddle_tpu``.
"""

import argparse
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

# H100 SXM data-sheet peaks (dense): f32 outside the tensor cores, HBM3;
# f32-accurate products on the tensor cores take three TF32 products each
# (3xTF32), so their least time is at a third of the 495 TFLOP/s TF32 rate
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES_PER_S = 3.35e12
BOUND_RATE = ('operations at 165 TFLOP/s (3xTF32 on the tensor cores), '
              'bytes at 3.35 TB/s')


def bound(flops, nbytes):
    """(bound_ms, bound_by, bound_simt_ms) of f32 work: the larger of its
    operations at the 3xTF32 rate and its bytes at the HBM rate; and the
    same with the operations at the f32 rate outside the tensor cores."""
    t_ops, t_bytes = flops / PEAK_3XTF32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes',
            1e3 * max(flops / PEAK_F32_FLOPS, t_bytes))

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

# the stacked-LSTM IMDB model at its published widths (bench.py's
# stacked_lstm configuration: 3 layers, embedding and hidden 128, dictionary
# 5149, batch 128, sequences up to 64)
STACKED_LSTM = dict(dict_dim=5149, emb_dim=128, hid_dim=128, stacked_num=3,
                    class_dim=2)
LSTM_BATCH = 128
LSTM_MAX_LEN = 64
LSTM_LR = 0.002
LSTM_CPU_ROWS = 8        # rows of the request compared with the CPU
LSTM_CPU_TRAIN_ROWS = 16  # rows of the training step compared with the CPU
# LSTM kernels vs their plain versions, scaled by max(1, max|plain|).  f32:
# the same recurrence with h . W (and dgates . W^T, dW) summed in another
# order, over up to 64 dependent steps.  bf16: h rounds to bf16 at every
# step, so a sum taken in another order can land on the neighbouring bf16
# value (2^-8 relative) and that difference travels through the remaining
# steps; dW sums bf16 dgates and h in f32.
LSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
LSTM_WIDTHS = (32, 64, 128, 256, 512)  # the kernel-vs-plain sweep's D
# stacked-LSTM prediction, card vs CPU: 3 layers x 64 dependent steps of f32
# in another summation order on each side (the card's LSTM kernel against
# the CPU's scan path), then a 2-class softmax
LSTM_PRED_RTOL, LSTM_PRED_ATOL = 1e-4, 1e-6

LIBRARIES = ('flash_attention_fwd', 'flash_attention_bwd', 'lstm_fwd',
             'lstm_bwd')


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
        if name == 'flash_attention_fwd':
            check_fwd_build(path, log)
        elif name == 'lstm_bwd':
            check_bwd_build(path, log)
    print('build: %d libraries %.1f s' % (len(LIBRARIES),
                                          time.perf_counter() - t0),
          flush=True)


def _check_hmma(name, path, what):
    """Count the HMMA (tensor-core) instructions in library ``name``'s SASS
    (cuobjdump next to nvcc); fail if there are none."""
    from paddle_tpu_torch.ops.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), 'cuobjdump')
    sass = subprocess.run([cuobjdump, '-sass', str(path)], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, 'cuobjdump -sass failed: %s' % sass.stderr)
    hmma = [ln.split()[1] for ln in sass.stdout.splitlines()
            if 'HMMA' in ln and len(ln.split()) > 1]
    kinds = sorted(set(h for h in hmma if h.startswith('HMMA')))
    print('build: %s SASS holds %d HMMA instructions (%s)' %
          (name, len(hmma), ', '.join(kinds)), flush=True)
    check(hmma, '%s: no HMMA instruction in its SASS: %s does not run on '
          'the tensor cores' % (name, what))


def _ptxas_table(log):
    """{mangled kernel name: (registers, spill bytes stored + loaded)} from
    ptxas -v output."""
    table, fn = {}, None
    for line in log.splitlines():
        if 'Function properties for' in line:
            fn = line.split('Function properties for')[1].strip()
            table[fn] = [0, 0]
        elif 'bytes spill stores' in line and fn:
            nums = [int(w) for w in line.replace(',', ' ').split()
                    if w.isdigit()]
            table[fn][1] = nums[1] + nums[2]  # stack frame, stores, loads
        elif 'Used' in line and 'registers' in line and fn:
            words = line.split()
            table[fn][0] = int(words[words.index('Used') + 1])
    return {f: tuple(v) for f, v in table.items()}


def check_bwd_build(path, log):
    """The LSTM backward library: its dW kernel runs on the tensor cores
    (HMMA in the SASS), and no f32 instantiation of the walk spills; prints
    every walk and dW instantiation's registers and spills."""
    import re
    _check_hmma('lstm_bwd', path, 'the dW kernel')
    if log is None:
        print('build: lstm_bwd spills: not checked (previous build reused)')
        return
    names = {'f': 'f32', '13__nv_bfloat16': 'bf16'}
    walk_f32 = []
    for fn, (regs, spill) in sorted(_ptxas_table(log).items()):
        walk = re.search(r'lstm_bwd_walk_kernelI(f|13__nv_bfloat16)Li(\d)E',
                         fn)
        dw = re.search(r'lstm_dw_partial_kernelI(f|13__nv_bfloat16)E', fn)
        if walk:
            what = 'walk %s UW=%s' % (names[walk.group(1)], walk.group(2))
            if walk.group(1) == 'f':
                walk_f32.append(spill)
        elif dw:
            what = 'dW %s' % names[dw.group(1)]
        else:
            continue
        print('build: lstm_bwd %-16s %3d registers, %d spill bytes' %
              (what, regs, spill), flush=True)
    check(len(walk_f32) == 3 and not any(walk_f32),
          'lstm_bwd: an f32 walk instantiation spills or is missing: %s' %
          walk_f32)


def check_fwd_build(path, log):
    """The forward library runs on the tensor cores (HMMA instructions in its
    SASS, counted with cuobjdump) and its f32 instantiations spill nothing
    (ptxas; checked when this run compiled the library)."""
    _check_hmma('flash_attention_fwd', path, 'the forward kernel')
    if log is None:
        print('build: flash_attention_fwd spills: not checked (previous '
              'build reused)')
        return
    spills = {f: n for f, (_, n) in _ptxas_table(log).items()}
    f32 = {f: n for f, n in spills.items() if 'fwd_kernelIf' in f}
    print('build: flash_attention_fwd f32 instantiations, spill bytes '
          '(stores + loads): %s' % ', '.join(
              '%s %d' % (f[f.index('fwd_kernelIf'):][:17], n)
              for f, n in sorted(f32.items())), flush=True)
    check(len(f32) == 4 and not any(f32.values()),
          'flash_attention_fwd: f32 instantiations spill or are missing: %s'
          % f32)


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


def _lstm_inputs(dtype, b, t, d, ragged, seed):
    """Recurrence inputs on the card.  W is scaled by 1/sqrt(D): at a fixed
    scale the recurrence turns chaotic as D grows (with N(0, 0.2^2) weights
    the plain version's own f32 and f64 runs part at D=512 after 64 steps),
    and a chaotic recurrence magnifies any summation-order difference."""
    g = torch.Generator(device='cuda')
    g.manual_seed(seed)
    rnd = lambda scale, *shape: torch.randn(*shape, device='cuda',
                                            generator=g) * scale
    xs = rnd(0.3, t, b, 4 * d).to(dtype)
    w = rnd(d**-0.5, d, 4 * d).to(dtype)
    bias = rnd(0.1, 1, 4 * d)
    h0, c0 = rnd(0.5, b, d).to(dtype), rnd(0.5, b, d)
    if ragged:
        lens = torch.randint(0, t + 1, (b, ), device='cuda', generator=g)
        lens[0], lens[-1] = 0, t
    else:
        lens = torch.full((b, ), t, device='cuda')
    mask = (torch.arange(t, device='cuda')[:, None] <
            lens[None, :]).float().contiguous()
    dhs, dcs = rnd(1.0, t, b, d).to(dtype), rnd(1.0, t, b, d)
    return xs, w, bias, h0, c0, mask, dhs, dcs


def phase_lstm_vs_plain():
    """The LSTM forward kernel (with and without the saved activations), the
    backward walk and the dW kernel against lstm_fwd_plain / lstm_bwd_plain
    on the same inputs (the backward on the plain forward's hs, cs, acts)."""
    from paddle_tpu_torch.ops.kernels import lstm as lk
    worst = {(dt, k): 0.0 for dt in LSTM_TOL
             for k in ('lstm_fwd', 'lstm_bwd', 'lstm_dw')}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in LSTM_WIDTHS:
            for b in (LSTM_BATCH, 13):
                for t in (LSTM_MAX_LEN, 1):
                    for ragged in (False, True):
                        xs, w, bias, h0, c0, mask, dhs, dcs = _lstm_inputs(
                            dtype, b, t, d, ragged, SEED + 2000 + n)
                        plain = lk.lstm_fwd_plain(xs, w, bias, h0, c0, mask)
                        bare = lk.lstm_fwd(xs, w, bias, h0, c0, mask,
                                           save_acts=False)
                        full = lk.lstm_fwd(xs, w, bias, h0, c0, mask)
                        phs, pcs, pacts = plain
                        got_b = lk.lstm_bwd(w, mask, pacts, pcs, phs, h0, c0,
                                            dhs, dcs)
                        want_b = lk.lstm_bwd_plain(w, mask, pacts, pcs, phs,
                                                   h0, c0, dhs, dcs)
                        torch.cuda.synchronize()
                        case = '%s D=%d B=%d T=%d %s N=%d' % (
                            str(dtype)[6:], d, b, t,
                            'ragged' if ragged else 'full',
                            lk.walk_cluster(b, d, dtype))
                        pairs = [('lstm_fwd', 'hs', bare[0], phs),
                                 ('lstm_fwd', 'cs', bare[1], pcs),
                                 ('lstm_fwd', 'hs+acts', full[0], phs),
                                 ('lstm_fwd', 'cs+acts', full[1], pcs),
                                 ('lstm_fwd', 'acts', full[2], pacts)]
                        pairs += [(k, name, g_, w_) for k, name, g_, w_ in zip(
                            ('lstm_bwd', 'lstm_dw', 'lstm_dw', 'lstm_bwd',
                             'lstm_bwd'), ('dx', 'dW', 'db', 'dh0', 'dc0'),
                            got_b, want_b)]
                        errs = []
                        for kernel, name, got, want in pairs:
                            scale = max(1.0, want.float().abs().max().item())
                            err = (got.float() - want.float()).abs().max().item()
                            check(got.shape == want.shape and
                                  err <= LSTM_TOL[dtype] * scale,
                                  'LSTM kernel disagrees with plain: %s: '
                                  'max|d%s| %g > %g * %g' %
                                  (case, name, err, LSTM_TOL[dtype], scale))
                            worst[dtype, kernel] = max(worst[dtype, kernel],
                                                       err)
                            errs.append('%s %.2g' % (name, err))
                        n += 1
                        print('lstm vs plain: %-32s %s' % (case,
                                                           ', '.join(errs)))
    for dtype in LSTM_TOL:
        print('lstm vs plain: %s worst max|d| forward %.3g, walk %.3g, dW/db '
              '%.3g (tol %g * max(1, max|plain|))' %
              ((str(dtype)[6:], ) +
               tuple(worst[dtype, k] for k in ('lstm_fwd', 'lstm_bwd',
                                               'lstm_dw')) +
               (LSTM_TOL[dtype], )))
    print('lstm vs plain: %d cases agree (N: the walk\'s CTAs a cluster)'
          % n, flush=True)
    check_walk_clusters()
    return {k: worst[torch.float32, k]
            for k in ('lstm_fwd', 'lstm_bwd', 'lstm_dw')}


def check_walk_clusters():
    """The walk at every cluster size that divides D into at most 128 units
    a CTA, against the plain version (dx, dh0, dc0, and db as the sum of the
    clusters' rows) within LSTM_TOL, and bitwise against the size the library
    picks: each (row, unit) sum runs in the same order whichever CTA owns
    the unit."""
    from paddle_tpu_torch.ops.kernels import lstm as lk
    for dtype in (torch.float32, torch.bfloat16):
        for d, b in ((128, LSTM_BATCH), (128, 13), (32, LSTM_BATCH),
                     (512, LSTM_BATCH)):
            xs, w, bias, h0, c0, mask, dhs, dcs = _lstm_inputs(
                dtype, b, LSTM_MAX_LEN, d, True, SEED + 3000 + d + b)
            hs, cs, acts = lk.lstm_fwd_plain(xs, w, bias, h0, c0, mask)
            args = (w, mask, acts, cs, h0, c0, dhs, dcs)
            want = lk.lstm_bwd_plain(w, mask, acts, cs, hs, h0, c0, dhs, dcs)
            want = (want[0], want[3], want[4], want[2][0])
            picked = lk._launch_walk(*args)
            same = []
            for n in [n for n in (1, 2, 4, 8)
                      if d // n <= 128 and d // n * dtype.itemsize % 16 == 0]:
                got = lk._launch_walk(*args, cluster=n)
                torch.cuda.synchronize()
                got = got[:3] + (got[3].sum(0), )
                for name, g, w_ in zip(('dx', 'dh0', 'dc0', 'db'), got, want):
                    scale = max(1.0, w_.float().abs().max().item())
                    err = (g.float() - w_.float()).abs().max().item()
                    check(err <= LSTM_TOL[dtype] * scale,
                          'lstm walk: %s D=%d B=%d with clusters of %d CTAs: '
                          'max|d%s| %g > %g * %g' % (str(dtype)[6:], d, b, n,
                                                     name, err,
                                                     LSTM_TOL[dtype], scale))
                check(all(torch.equal(g, p_)
                          for g, p_ in zip(got[:3], picked[:3])),
                      'lstm walk: %s D=%d B=%d with clusters of %d CTAs is '
                      'not bitwise the picked size\'s' % (str(dtype)[6:], d,
                                                           b, n))
                same.append(str(n))
            print('lstm walk: %s D=%d B=%d T=%d ragged: clusters of %s CTAs '
                  'agree with plain and bitwise with the picked size, %d' %
                  (str(dtype)[6:], d, b, LSTM_MAX_LEN, ', '.join(same),
                   lk.walk_cluster(b, d, dtype)), flush=True)


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
    from paddle_tpu_torch.ops.kernels import lstm as lk
    return {'fwd': fa.LAUNCHES, 'dq': fa.LAUNCHES_DQ, 'dkv': fa.LAUNCHES_DKV,
            'lstm_fwd': lk.LAUNCHES_FWD, 'lstm_bwd': lk.LAUNCHES_BWD,
            'lstm_dw': lk.LAUNCHES_DW}


def _zero_counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import lstm as lk
    fa.LAUNCHES = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
    lk.LAUNCHES_FWD = lk.LAUNCHES_BWD = lk.LAUNCHES_DW = 0


def _grew(before):
    after = _counts()
    return {k: after[k] - before[k] for k in after}


def _expect(**nonzero):
    """A full launch-count dict: the named counters, every other one 0."""
    out = dict.fromkeys(_counts(), 0)
    out.update(nonzero)
    return out


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
        before = _counts()
        t0 = time.perf_counter()
        loss, pred = exe.run(model['test'], feed=feed, fetch_list=fetch,
                             scope=scope)
        walls.append(time.perf_counter() - t0)
        grew = _grew(before)
        check(grew == _expect(fwd=per_request), 'request %d launched %s, '
              'expected %d flash forward launches and nothing else' %
              (i, grew, per_request))
        grew = grew['fwd']
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
    per_step = _expect(fwd=2 * n_flash, dq=n_flash, dkv=n_flash)
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
        grew = _grew(before)
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
    """One Transformer training step on the card and on the CPU from the
    same state."""
    seq, vocab = TRANSFORMER_BASE['max_len'], TRANSFORMER_BASE['trg_vocab']
    rng = np.random.RandomState(SEED + 2)
    feed = {name: rng.randint(1, vocab, size=(2, seq)).astype('int64')
            for name in model['feeds']}
    compare_train_step(card, 'train', '2 x %d' % seq, model['main'],
                       model['loss'].name, feed, scope, exe, LR)


def compare_train_step(card, tag, what, main, loss_name, feed, scope, exe,
                       lr):
    """Hand the card's state (parameters, moments, beta powers, learning
    rate) to a CPUPlace() scope, run one step of ``main`` on each, and hold
    the card to the CPU: loss, every ``<param>@GRAD``, updated parameters."""
    import paddle_tpu_torch.fluid as fluid
    state = [v.name for v in main.list_vars() if v.persistable]
    cpu_scope = fluid.Scope()
    fluid.persistables_from_numpy(
        main, {n: scope.find_var(n).value().cpu().numpy() for n in state},
        scope=cpu_scope, place=fluid.CPUPlace())
    params = [p.name for p in main.all_parameters()]
    fetch = [loss_name] + [p + '@GRAD' for p in params]
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    t0 = time.perf_counter()
    want = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                                fetch_list=fetch,
                                                scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    loss_rel = float(abs(got[0][0] - want[0][0]) / abs(want[0][0]))
    check(loss_rel < SLICE_RTOL, '%s step, card vs CPU: loss %.7f vs %.7f '
          '(rel %g)' % (tag, got[0][0], want[0][0], loss_rel))
    top = max(float(np.abs(w).max()) for w in want[1:])
    grad_err, diff_sq, norm_sq = 0.0, 0.0, 0.0
    for name, g, w in zip(params, got[1:], want[1:]):
        err = float(np.abs(g - w).max())
        own = float(np.abs(w).max())
        check(err <= GRAD_RTOL * own + GRAD_ATOL * top,
              '%s step, card vs CPU: %s@GRAD max|dg| %g > %g * %g + %g * %g'
              % (tag, name, err, GRAD_RTOL, own, GRAD_ATOL, top))
        grad_err = max(grad_err, err / (GRAD_RTOL * own + GRAD_ATOL * top))
        diff_sq += float(np.square(g - w, dtype=np.float64).sum())
        norm_sq += float(np.square(w, dtype=np.float64).sum())
    norm_err = math.sqrt(diff_sq / norm_sq)
    check(norm_err <= GRAD_NORM_TOL, '%s step, card vs CPU: |dg| / |g| over '
          'all gradients %g (tol %g)' % (tag, norm_err, GRAD_NORM_TOL))
    worst, n_far, n_all = 0.0, 0, 0
    for name in params:
        dp = np.abs(scope.find_var(name).value().cpu().numpy() -
                    cpu_scope.find_var(name).value().numpy())
        worst = max(worst, float(dp.max()))
        n_far += int((dp > PARAM_ATOL).sum())
        n_all += dp.size
    check(worst <= lr and n_far <= PARAM_FRAC * n_all,
          '%s step, card vs CPU: updated parameters differ by up to %g '
          '(limit lr %g), %d of %d elements by more than %g (limit %g of '
          'them)' % (tag, worst, lr, n_far, n_all, PARAM_ATOL, PARAM_FRAC))
    print('%s: card vs CPU, one step on %s from the same state: loss %.6f vs '
          '%.6f (rel %.2g, tol %g); %d gradients: the worst max|dg| is %.3g '
          'of its allowance (%g of its max|g| + %g of the largest, %.3g), '
          '|dg| / |g| over all %.3g (tol %g); updated parameters: max|dp| '
          '%.3g (limit lr %g), %d of %d elements differ by more than %g '
          '(limit %g of them); CPU step %.2f s [%s]' %
          (tag, what, got[0][0], want[0][0], loss_rel, SLICE_RTOL,
           len(params), grad_err, GRAD_RTOL, GRAD_ATOL, top, norm_err,
           GRAD_NORM_TOL, worst, lr, n_far, n_all, PARAM_ATOL, PARAM_FRAC,
           cpu_s, card), flush=True)


def stacked_lstm_programs(fluid, use_peepholes=True, dict_dim=5149,
                          class_dim=2, emb_dim=128, hid_dim=128,
                          stacked_num=3, lr=0.002):
    """``stacked_lstm.build()``'s programs, built with the public
    ``fluid.layers`` of ``fluid`` (either package) with every LSTM's
    ``use_peepholes`` chosen: True gives the model as built, False the same
    net at the same widths, whose LSTMs the kernels take."""
    main, startup = fluid.Program(), fluid.Program()
    layers = fluid.layers
    with fluid.program_guard(main, startup):
        data = layers.data(name='words', shape=[1], dtype='int64',
                           lod_level=1)
        label = layers.data(name='label', shape=[1], dtype='int64')
        emb = layers.embedding(input=data, size=[dict_dim, emb_dim],
                               is_sparse=False)
        fc1 = layers.fc(input=emb, size=hid_dim * 4)
        lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim * 4,
                                       use_peepholes=use_peepholes)
        inputs = [fc1, lstm1]
        for i in range(2, stacked_num + 1):
            fc = layers.fc(input=inputs, size=hid_dim * 4)
            lstm, _ = layers.dynamic_lstm(input=fc, size=hid_dim * 4,
                                          use_peepholes=use_peepholes,
                                          is_reverse=(i % 2) == 0)
            inputs = [fc, lstm]
        fc_last = layers.sequence_pool(input=inputs[0], pool_type='max')
        lstm_last = layers.sequence_pool(input=inputs[1], pool_type='max')
        prediction = layers.fc(input=[fc_last, lstm_last], size=class_dim,
                               act='softmax')
        loss = layers.mean(layers.cross_entropy(input=prediction,
                                                label=label))
        acc = layers.accuracy(input=prediction, label=label)
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return dict(main=main, startup=startup, test=test,
                feeds=['words', 'label'], prediction=prediction, loss=loss,
                acc=acc)


def lstm_request(rng, rows):
    """A LoD request of ``rows`` sequences, lengths in [1, LSTM_MAX_LEN] with
    one row at LSTM_MAX_LEN, word ids and 0/1 labels, drawn from ``rng``."""
    import paddle_tpu_torch.fluid as fluid
    lengths = rng.randint(1, LSTM_MAX_LEN + 1, size=rows)
    lengths[rng.randint(rows)] = LSTM_MAX_LEN
    ids = rng.randint(0, STACKED_LSTM['dict_dim'],
                      size=(int(lengths.sum()), 1)).astype('int64')
    label = rng.randint(0, STACKED_LSTM['class_dim'],
                        size=(rows, 1)).astype('int64')
    return {'words': fluid.create_lod_tensor(ids, [lengths.tolist()]),
            'label': label}


def build_lstm_models():
    """The two forms of the stacked-LSTM model, {'kernel': no peepholes,
    'as built': stacked_lstm.build()}: (model, scope, executor), each with
    its startup run on the card."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import stacked_lstm
    forms = {}
    for form in ('kernel', 'as built'):
        with fluid.unique_name.guard():
            if form == 'as built':
                model = stacked_lstm.build(lr=LSTM_LR, **STACKED_LSTM)
            else:
                model = stacked_lstm_programs(fluid, use_peepholes=False,
                                              lr=LSTM_LR, **STACKED_LSTM)
        model['startup'].random_seed = SEED
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(model['startup'], scope=scope)
        forms[form] = (model, scope, exe)
    torch.cuda.synchronize()
    n_params = sum(math.prod(p.shape)
                   for p in forms['as built'][0]['test'].all_parameters())
    print('model: stacked LSTM %s, %d parameters as built (peepholes), Adam '
          'lr %g; FLAGS_fused_lstm=%r' % (STACKED_LSTM, n_params, LSTM_LR,
                                          fluid.FLAGS.fused_lstm),
          flush=True)
    return forms


class _ScanCount(object):
    """Counts calls of the lstm op's scan path while active."""

    def __enter__(self):
        from paddle_tpu_torch.ops import sequence_ops
        self.calls = 0
        self._real = sequence_ops._lstm_scan

        def counted(*args):
            self.calls += 1
            return self._real(*args)

        sequence_ops._lstm_scan = counted
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import sequence_ops
        sequence_ops._lstm_scan = self._real


def phase_lstm_serve(card, forms):
    """Four 128-row LoD requests of each form's test program, then each
    form's 8-row request on the card and on the CPU."""
    import paddle_tpu_torch.fluid as fluid
    n_layers = STACKED_LSTM['stacked_num']
    rng = np.random.RandomState(SEED + 3)
    requests = [lstm_request(rng, LSTM_BATCH) for _ in range(REQUESTS)]
    small = lstm_request(rng, LSTM_CPU_ROWS)
    launches = None
    for form, (model, scope, exe) in forms.items():
        fetch = [model['prediction'], model['acc']]
        kernel = form == 'kernel'
        per_request = _expect(lstm_fwd=n_layers) if kernel else _expect()
        walls = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()  # every launch counter to 0 just before this path
        for i, feed in enumerate(requests):
            before = _counts()
            with _ScanCount() as scans:
                t0 = time.perf_counter()
                pred, acc = exe.run(model['test'], feed=feed,
                                    fetch_list=fetch, scope=scope)
                walls.append(time.perf_counter() - t0)
            grew = _grew(before)
            check(grew == per_request and
                  scans.calls == (0 if kernel else n_layers),
                  'lstm serve (%s): request %d launched %s and ran the scan '
                  'path %d times, expected %s and %d' %
                  (form, i, grew, scans.calls, per_request,
                   0 if kernel else n_layers))
            row_err = float(np.abs(pred.sum(-1, dtype=np.float64) - 1).max())
            check(pred.shape == (LSTM_BATCH, STACKED_LSTM['class_dim']) and
                  np.isfinite(pred).all() and row_err < 1e-5 and
                  0 <= acc[0] <= 1,
                  'lstm serve (%s): request %d prediction %s, rows sum to 1 '
                  '+- %g, accuracy %s' % (form, i, pred.shape, row_err, acc))
            print('lstm serve (%s): request %d wall %.4f s, accuracy %.4f, '
                  'launches %s, scan path %d times [%s]' %
                  (form, i + 1, walls[-1], acc[0],
                   {k: v for k, v in grew.items() if v}, scans.calls, card),
                  flush=True)
        if kernel:
            launches = _counts()
        steady = statistics.median(walls[1:])
        tokens = sum(len(r['words'].numpy()) for r in requests[1:]) / (
            REQUESTS - 1)
        print('lstm serve (%s): %d requests of %d rows (T=%d); steady request '
              'wall %.4f s (median of requests 2-%d), %.0f rows/s, %.0f '
              'tokens/s; peak device memory %.1f MiB [%s]' %
              (form, REQUESTS, LSTM_BATCH, LSTM_MAX_LEN, steady, REQUESTS,
               LSTM_BATCH / steady, tokens / steady,
               torch.cuda.max_memory_allocated() / 2**20, card), flush=True)

        gpred, gacc = exe.run(model['test'], feed=small, fetch_list=fetch,
                              scope=scope)
        cpu_scope = fluid.Scope()
        fluid.params_from_numpy(
            model['test'],
            {p.name: scope.find_var(p.name).value().cpu().numpy()
             for p in model['test'].all_parameters()},
            scope=cpu_scope, place=fluid.CPUPlace())
        cpred, cacc = fluid.Executor(fluid.CPUPlace()).run(
            model['test'], feed=small, fetch_list=fetch, scope=cpu_scope)
        err = float(np.abs(gpred - cpred).max())
        check(np.allclose(gpred, cpred, rtol=LSTM_PRED_RTOL,
                          atol=LSTM_PRED_ATOL),
              'lstm serve (%s): card and CPU disagree: max|dpred| %g (rtol '
              '%g, atol %g)' % (form, err, LSTM_PRED_RTOL, LSTM_PRED_ATOL))
        # accuracy may differ only through a row the two sides nearly tie on
        ties = int((np.abs(cpred[:, 0] - cpred[:, 1]) < 2 * err + 1e-7).sum())
        check(abs(gacc[0] - cacc[0]) * LSTM_CPU_ROWS <= ties + 1e-6,
              'lstm serve (%s): accuracy %g on the card, %g on the CPU' %
              (form, gacc[0], cacc[0]))
        print('lstm serve (%s): card vs CPU on %d rows: max|dpred| %.3g (rtol '
              '%g, atol %g), accuracy %.4f vs %.4f [%s]' %
              (form, LSTM_CPU_ROWS, err, LSTM_PRED_RTOL, LSTM_PRED_ATOL,
               gacc[0], cacc[0], card), flush=True)
    return launches


def phase_lstm_train(card, forms):
    """TRAIN_STEPS Adam steps of the kernel form on one 128-row batch."""
    model, scope, exe = forms['kernel']
    n = STACKED_LSTM['stacked_num']
    feed = lstm_request(np.random.RandomState(SEED + 4), LSTM_BATCH)
    # each lstm op: one forward launch without the activations in the
    # forward pass; its generic grad replays the forward (through LSTMCore,
    # saving the activations) and runs the walk and the dW kernels once
    per_step = _expect(lstm_fwd=2 * n, lstm_bwd=n, lstm_dw=n)
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
        grew = _grew(before)
        check(grew == per_step, 'lstm train: step %d launched %s, expected %s'
              % (step + 1, grew, per_step))
        check(loss.shape == (1, ) and np.isfinite(loss).all(),
              'lstm train: step %d loss %s is not finite' % (step + 1, loss))
        losses.append(float(loss[0]))
        print('lstm train: step %d wall %.4f s, loss %.6f, launches %s [%s]' %
              (step + 1, walls[-1], losses[-1],
               {k: v for k, v in grew.items() if v}, card), flush=True)
    launches = _counts()
    from paddle_tpu_torch.ops.kernels import lstm as lk
    print('lstm train: each walk launch runs clusters of %d CTAs (B=%d, D=%d,'
          ' f32)' % (lk.walk_cluster(LSTM_BATCH, STACKED_LSTM['hid_dim'],
                                     torch.float32), LSTM_BATCH,
                     STACKED_LSTM['hid_dim']), flush=True)
    check(all(b < a for a, b in zip(losses, losses[1:])),
          'lstm train: the loss did not fall at every step: %s' % losses)
    print('lstm train: %d Adam steps (lr %g) on one %d-row batch (T=%d), '
          'loss %.6f -> %.6f, falling at every step; launches %s (%s per '
          'step); steady step wall %.4f s (median of steps 2-%d); peak device '
          'memory %.1f MiB [%s]' %
          (TRAIN_STEPS, LSTM_LR, LSTM_BATCH, LSTM_MAX_LEN, losses[0],
           losses[-1], {k: v for k, v in launches.items() if v},
           {k: v for k, v in per_step.items() if v},
           statistics.median(walls[1:]), TRAIN_STEPS,
           torch.cuda.max_memory_allocated() / 2**20, card), flush=True)
    return launches


def phase_lstm_train_card_vs_cpu(card, forms):
    """One training step of each form on the card and on the CPU from the
    same state (the kernel form after its five steps, the form as built from
    its startup)."""
    feed = lstm_request(np.random.RandomState(SEED + 5), LSTM_CPU_TRAIN_ROWS)
    for form, (model, scope, exe) in forms.items():
        compare_train_step(card, 'lstm train (%s)' % form,
                           '%d rows (T=%d)' % (LSTM_CPU_TRAIN_ROWS,
                                               LSTM_MAX_LEN),
                           model['main'], model['loss'].name, feed, scope,
                           exe, LSTM_LR)


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


def _activity_name(name):
    """A device activity's name without its argument list."""
    return name.replace('(anonymous namespace)::', '').split('(')[0].strip()


def _device_ms(fn, calls=20, warmup=3):
    """(device time of one call in ms, names of the device activities it
    ran) under torch.profiler, over ``calls`` back-to-back calls: for each
    activity, its median duration times its count per call (rounded, so
    that an event the profiler drops moves nothing), summed.  The wrapper's
    host work does not count.  A count that is not a multiple of ``calls``
    is printed; (None, names) when the profiler saw no device events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    durations = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            durations.setdefault(e.name, []).append(
                e.time_range.elapsed_us())
    names = sorted(set(_activity_name(n)[:100] for n in durations))
    for name, d in sorted(durations.items()):
        if len(d) % calls:
            print('times: %d device events of %s in %d calls' %
                  (len(d), _activity_name(name)[:100], calls), flush=True)
    if not durations:
        print('times: no device event in %d calls' % calls, flush=True)
        return None, names
    return sum(max(1, round(len(d) / calls)) * statistics.median(d)
               for d in durations.values()) / 1e3, names


def _kernel_device_ms(fn, name):
    """The device time of one call of a kernel's wrapper; fails without it."""
    ms = _device_ms(fn)[0]
    check(ms is not None, '%s: torch.profiler gave no device time' % name)
    return ms


def _fmt_ms(ms):
    return 'not measured' if ms is None else '%.4f ms' % ms


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
    calls = {
        'fwd': lambda: fa.flash_attention_fwd(q, k, v),
        'dq': lambda: fa._launch_dq(q, k, v, do, lse, delta, None, False,
                                    scale),
        'dkv': lambda: fa._launch_dkv(q, k, v, do, lse, delta, None, False,
                                      scale),
    }
    ms = {key: _time_ms(fn) for key, fn in calls.items()}
    # the same calls' device time alone, without the wrappers' host work
    device_ms = {key: _kernel_device_ms(fn, key)
                 for key, fn in calls.items()}
    delta_ms = _time_ms(lambda: fa.bwd_delta(o, do))
    plain_ms = {'fwd': _time_ms(lambda: fa.flash_attention_plain(q, k, v))}
    # the plain backward computes dQ, dK and dV in one call: both backward
    # rows carry its time
    plain_ms['dq'] = plain_ms['dkv'] = _time_ms(
        lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do))
    sdpa_fwd = lambda: sdpa(qt, kt, vt)
    library_ms = {'fwd': _time_ms(sdpa_fwd)}
    library_device_ms = {}
    library_device_ms['fwd'], fwd_names = _device_ms(sdpa_fwd)
    # SDPA's backward alone: one call gives dQ, dK and dV, so both backward
    # rows carry this combined time
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    out = sdpa(qg, kg, vg)
    dout = do.transpose(1, 2).contiguous()
    sdpa_bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), dout,
                                           retain_graph=True)
    library_ms['dq'] = library_ms['dkv'] = _time_ms(sdpa_bwd)
    bwd_dev, bwd_names = _device_ms(sdpa_bwd)
    library_device_ms['dq'] = library_device_ms['dkv'] = bwd_dev
    print('times: SDPA f32 ran, forward: %s; backward: %s [%s]' %
          (', '.join(fwd_names), ', '.join(bwd_names), card), flush=True)
    # least time of each call: its products (2 FLOP per multiply-add, every
    # (row, column) pair unmasked here) at the 3xTF32 rate, against its
    # inputs read once and its outputs written once at the HBM rate
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
        bound_ms, bound_by, bound_simt_ms = bound(flops, nbytes)
        name, src, line = sources[key]
        print('times: %s f32 B=%d Lq=Lk=%d H=%d D=%d non-causal: kernel %.4f '
              'ms (device %s), plain %.4f ms, library %.4f ms (device %s), '
              'bound %.4f ms by %s (%.3g GFLOP, %.3g MB; %s), %.4f ms at 67 '
              'TFLOP/s f32 [%s]' %
              (name, b, seq, h, d, ms[key], _fmt_ms(device_ms[key]),
               plain_ms[key], library_ms[key],
               _fmt_ms(library_device_ms[key]), bound_ms, bound_by,
               flops / 1e9, nbytes / 1e6, BOUND_RATE, bound_simt_ms, card),
              flush=True)
        kernels.append({
            'name': name,
            'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/' + src,
            'replaces': 'paddle_tpu/ops/pallas/flash_attention.py:%d' % line,
            'launches': launches['train'][key],
            'launches_by_path': {p: launches[p][key] for p in launches},
            'max_abs_err': err[key],
            'ms': ms[key],
            'device_ms': device_ms[key],
            'plain_ms': plain_ms[key],
            'bound_ms': bound_ms,
            'bound_by': bound_by,
            'bound_rate': BOUND_RATE,
            'library_ms': library_ms[key],
            'library_device_ms': library_device_ms[key],
        })
    # the forward in bf16 at the same shape, beside SDPA's bf16 call
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    qtb, ktb, vtb = (x.transpose(1, 2).contiguous() for x in (qb, kb, vb))
    kernel_bf16 = lambda: fa.flash_attention_fwd(qb, kb, vb)
    sdpa_bf16 = lambda: sdpa(qtb, ktb, vtb)
    bf16 = [(_time_ms(kernel_bf16),
             _kernel_device_ms(kernel_bf16, 'fwd bf16')),
            (_time_ms(sdpa_bf16), _device_ms(sdpa_bf16)[0])]
    print('times: flash_attention_fwd bf16 at the same shape: kernel %.4f ms '
          '(device %s), SDPA bf16 %.4f ms (device %s) [%s]' %
          (bf16[0][0], _fmt_ms(bf16[0][1]), bf16[1][0], _fmt_ms(bf16[1][1]),
           card), flush=True)
    print('times: backward at the slice shape: dQ %.4f + dK/dV %.4f + delta '
          '%.4f = %.4f ms against SDPA backward (dQ, dK, dV in one call) '
          '%.4f ms; device time dQ %s + dK/dV %s against SDPA backward %s; '
          'plain backward %.4f ms [%s]' %
          (ms['dq'], ms['dkv'], delta_ms, ms['dq'] + ms['dkv'] + delta_ms,
           library_ms['dq'], _fmt_ms(device_ms['dq']),
           _fmt_ms(device_ms['dkv']), _fmt_ms(library_device_ms['dq']),
           plain_ms['dq'], card), flush=True)
    return kernels


def _lstm_op(fluid, d):
    """A one-op program: the ``lstm`` op of the kernel form's layers
    (no peepholes) over a LoD input of width 4D; (block, op)."""
    prog = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog,
                                                         fluid.Program()):
        x = fluid.layers.data(name='x', shape=[4 * d], dtype='float32',
                              lod_level=1)
        fluid.layers.dynamic_lstm(input=x, size=4 * d, use_peepholes=False)
    block = prog.global_block()
    return block, [op for op in block.ops if op.type == 'lstm'][0]


def phase_lstm_times(card, launches, err):
    """The LSTM kernels, their plain versions and cuDNN's LSTM at the
    slice's shape (f32, B=128, T=64, D=128, every row full length), and the
    lstm op's two paths on the card."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.kernels import lstm as lk
    b, t, d = LSTM_BATCH, LSTM_MAX_LEN, STACKED_LSTM['hid_dim']
    xs, w, bias, h0, c0, mask, dhs, dcs = _lstm_inputs(
        torch.float32, b, t, d, False, SEED + 6)
    hs, cs, acts = lk.lstm_fwd(xs, w, bias, h0, c0, mask)
    dx, _, _, db_part = lk._launch_walk(w, mask, acts, cs, h0, c0, dhs, dcs)
    calls = {
        'lstm_fwd': lambda: lk.lstm_fwd(xs, w, bias, h0, c0, mask,
                                        save_acts=False),
        'lstm_bwd': lambda: lk._launch_walk(w, mask, acts, cs, h0, c0, dhs,
                                            dcs),
        'lstm_dw': lambda: lk._launch_dw(hs, h0, dx, db_part),
    }
    ms = {key: _time_ms(fn) for key, fn in calls.items()}
    device_ms = {key: _kernel_device_ms(fn, key)
                 for key, fn in calls.items()}
    fwd_acts_ms = _time_ms(lambda: lk.lstm_fwd(xs, w, bias, h0, c0, mask))
    # the walk's device time at each cluster size (f32), and at bf16 beside
    # f32: bf16 halves the bytes of W, so where W streams from L2 (one CTA
    # a cluster) the gap between the two prices that streaming
    cluster = lk.walk_cluster(b, d, torch.float32)
    by_cluster = {n: _kernel_device_ms(
        lambda: lk._launch_walk(w, mask, acts, cs, h0, c0, dhs, dcs,
                                cluster=n), 'lstm_bwd N=%d' % n)
        for n in (1, 2, 4, 8)}
    xb, wb, hb, dhb = (x.to(torch.bfloat16) for x in (xs, w, h0, dhs))
    _, csb, actsb = lk.lstm_fwd(xb, wb, bias, hb, c0, mask)
    walk_bf16 = lambda n=0: lk._launch_walk(wb, mask, actsb, csb, hb, c0, dhb,
                                            dcs, cluster=n)
    bf16_ms = _time_ms(walk_bf16)
    bf16_device = {n: _kernel_device_ms(lambda: walk_bf16(n),
                                        'lstm_bwd bf16 N=%d' % n)
                   for n in (0, 1)}
    print('times: lstm_bwd walk device time by cluster size (f32 B=%d T=%d '
          'D=%d; the library picks %d): %s; bf16 %.4f ms (device %s, %s at '
          'N=1; the library picks %d) [%s]' %
          (b, t, d, cluster, ', '.join('N=%d %s' % (n, _fmt_ms(v))
                                       for n, v in by_cluster.items()),
           bf16_ms, _fmt_ms(bf16_device[0]), _fmt_ms(bf16_device[1]),
           lk.walk_cluster(b, d, torch.bfloat16), card), flush=True)
    plain_ms = {'lstm_fwd': _time_ms(
        lambda: lk.lstm_fwd_plain(xs, w, bias, h0, c0, mask,
                                  save_acts=False), 2, 10)}
    # the plain backward computes dx, dW and db in one call: both backward
    # rows carry its time
    plain_ms['lstm_bwd'] = plain_ms['lstm_dw'] = _time_ms(
        lambda: lk.lstm_bwd_plain(w, mask, acts, cs, hs, h0, c0, dhs, dcs),
        2, 10)
    # cuDNN's LSTM at the same B, T and D; it also projects its 128-wide
    # input (x . W_ih, which the port's lstm op receives done)
    cudnn = torch.nn.LSTM(d, d).cuda()
    x_in = torch.randn(t, b, d, device='cuda')
    def cudnn_fwd():
        with torch.no_grad():
            return cudnn(x_in)

    library_ms = {'lstm_fwd': _time_ms(cudnn_fwd)}
    library_device_ms = {'lstm_fwd': _device_ms(cudnn_fwd)[0]}
    x_req = x_in.detach().requires_grad_()
    out, _ = cudnn(x_req)
    wrt = [x_req] + list(cudnn.parameters())
    dout = torch.randn_like(out)
    # cuDNN's backward gives dx and the weight gradients in one call: both
    # backward rows carry its time
    cudnn_bwd = lambda: torch.autograd.grad(out, wrt, dout, retain_graph=True)
    library_ms['lstm_bwd'] = library_ms['lstm_dw'] = _time_ms(cudnn_bwd)
    library_device_ms['lstm_bwd'] = library_device_ms['lstm_dw'] = \
        _device_ms(cudnn_bwd)[0]

    # the lstm op on the card, scan path ('never') and kernel ('auto'):
    # CUDA events around back-to-back runs of the lowering, so the host's
    # launch gaps count
    block, op = _lstm_op(fluid, d)
    env = {op.input('Input')[0]: xs.transpose(0, 1).contiguous(),
           op.input('Input')[0] + registry.SEQLEN_SUFFIX:
           torch.full((b, ), t, dtype=torch.int32, device='cuda'),
           op.input('Weight')[0]: w, op.input('Bias')[0]: bias}
    ctx = registry.LoweringContext(block, env, fluid.CUDAPlace(0))
    op_ms = {}
    with torch.no_grad():
        for mode in ('never', 'auto', 'never', 'auto'):
            fluid.FLAGS.fused_lstm = mode
            op_ms.setdefault(mode, []).append(_time_ms(
                lambda: registry.run_op(ctx, op), 2, 10))
    fluid.FLAGS.fused_lstm = 'auto'
    print('times: lstm op (B=%d T=%d D=%d f32, no peepholes) on the card: '
          'scan path (FLAGS_fused_lstm=never) %s ms, kernel path (auto) %s '
          'ms (two turns each, never/auto/never/auto) [%s]' %
          (b, t, d, ', '.join('%.4f' % v for v in op_ms['never']),
           ', '.join('%.4f' % v for v in op_ms['auto']), card), flush=True)

    # least time: the products (2 FLOP per multiply-add) at the 3xTF32
    # rate, against the inputs read once and the outputs written once
    gate_elems, h_elems = t * b * 4 * d, t * b * d
    flops = 2.0 * t * b * d * 4 * d
    work = {
        # xs, w, bias, h0, c0, mask -> hs, cs
        'lstm_fwd': (flops, 4 * (gate_elems + 4 * d * d + 4 * d + 2 * b * d +
                                 t * b + 2 * h_elems)),
        # w, mask, acts, cs, c0, dhs, dcs -> dx, dh0, dc0, db rows
        'lstm_bwd': (flops, 4 * (4 * d * d + t * b + 2 * gate_elems +
                                 3 * h_elems + 3 * b * d +
                                 math.ceil(b / 4) * 4 * d)),
        # hs, h0, dx, db rows -> dW, db
        'lstm_dw': (flops, 4 * (h_elems + b * d + gate_elems +
                                math.ceil(b / 4) * 4 * d + 4 * d * d +
                                4 * d)),
    }
    sources = {
        'lstm_fwd': ('lstm_fwd', 'lstm_fwd.cu', 41),
        'lstm_bwd': ('lstm_bwd', 'lstm_bwd.cu', 83),
        'lstm_dw': ('lstm_bwd_dw', 'lstm_bwd.cu', 83),
    }
    kernels = []
    for key in ('lstm_fwd', 'lstm_bwd', 'lstm_dw'):
        flops_k, nbytes = work[key]
        bound_ms, bound_by, bound_simt_ms = bound(flops_k, nbytes)
        name, src, line = sources[key]
        print('times: %s f32 B=%d T=%d D=%d: kernel %.4f ms (%.2f us a step; '
              'device %s), plain %.4f ms, cuDNN LSTM %.4f ms (device %s), '
              'bound %.4f ms by %s (%.3g GFLOP, %.3g MB; %s), %.4f ms at 67 '
              'TFLOP/s f32 [%s]' %
              (name, b, t, d, ms[key], 1e3 * ms[key] / t,
               _fmt_ms(device_ms[key]), plain_ms[key], library_ms[key],
               _fmt_ms(library_device_ms[key]), bound_ms, bound_by,
               flops_k / 1e9, nbytes / 1e6, BOUND_RATE, bound_simt_ms, card),
              flush=True)
        entry = {
            'name': name,
            'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/' + src,
            'replaces': 'paddle_tpu/ops/pallas/lstm.py:%d' % line,
            'launches': launches['lstm_train'][key],
            'launches_by_path': {p: launches[p][key] for p in launches},
            'max_abs_err': err[key],
            'ms': ms[key],
            'device_ms': device_ms[key],
            'plain_ms': plain_ms[key],
            'bound_ms': bound_ms,
            'bound_by': bound_by,
            'bound_rate': BOUND_RATE,
            'library_ms': library_ms[key],
            'library_device_ms': library_device_ms[key],
        }
        if key == 'lstm_fwd':
            entry['ms_with_acts'] = fwd_acts_ms
        if key == 'lstm_bwd':
            entry['cluster'] = cluster
            entry['device_ms_by_cluster'] = by_cluster
            entry['bf16_ms'] = bf16_ms
            entry['bf16_device_ms'] = bf16_device[0]
        kernels.append(entry)
    print('times: lstm_fwd with the activations saved %.4f ms; backward walk '
          '+ dW %.4f ms against cuDNN backward %.4f ms (includes its input '
          'projection\'s gradient); op scan path / kernel path %.1fx [%s]' %
          (fwd_acts_ms, ms['lstm_bwd'] + ms['lstm_dw'],
           library_ms['lstm_bwd'],
           statistics.median(op_ms['never']) /
           statistics.median(op_ms['auto']), card), flush=True)
    return kernels


def main():
    global SEED
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=SEED)
    SEED = ap.parse_args().seed
    card = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    fwd_err = phase_kernel_vs_plain()
    bwd_err = phase_bwd_vs_plain()
    lstm_err = phase_lstm_vs_plain()
    model, scope, exe = build_model()
    launches = {'serve': phase_slice(card, model, scope, exe),
                'train': phase_train(card, model, scope, exe)}
    phase_train_card_vs_cpu(card, model, scope, exe)
    forms = build_lstm_models()
    launches['lstm_serve'] = phase_lstm_serve(card, forms)
    launches['lstm_train'] = phase_lstm_train(card, forms)
    phase_lstm_train_card_vs_cpu(card, forms)
    kernels = phase_times(card, launches, fwd_err, bwd_err)
    kernels += phase_lstm_times(card, launches, lstm_err)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
