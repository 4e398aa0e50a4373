#!/usr/bin/env python3
"""Where the LSTM backward walk's time goes, step by step, on one CUDA card.

    python3 profile_lstm_walk.py     # from the repository root

Builds copies of ``paddle_tpu_torch/csrc/lstm_bwd.cu`` into ``build/`` with
``clock64()`` marks around the phases of the walk's step loop (thread 0 of
CTA 0 adds up the cycles of each phase over all steps), and runs them at the
stacked-LSTM slice's shape (f32, B=128, T=64, D=128, full lengths) with
clusters of 1, 2, 4 and 8 CTAs:

- ``marked``: the kernel as it is, marks only;
- ``dx_in_phase_a``: dx stored in phase A, right after the sends, as an
  earlier version did;
- ``no_prefetch``: without the copies of the next step's inputs, and
  ``no_product``: without phase B's product (both give wrong results: they
  price a phase by its absence).

For each it prints the call's time (CUDA events, median of 20 samples of 10
calls) and the cycles a step of each phase: the inputs' wait, phase A
(gate gradients and their sends), the prefetch's issue, the wait for the
cluster's dgates, phase B's product, and the butterfly, dx stores and block
barrier.  Then the dW kernel's time at 4 to 64 split-K slices, f32 and
bf16.  Prints the card's name, power limit and clocks first.  The marks
are placed by matching lines of the source (``profile_variants.py``): a
change there that moves them makes this script stop with the line it did
not find.
"""

import ctypes
import sys

import torch

import profile_variants  # (puts the repository on the path first)
import chip_smoke  # its input and timing helpers
from paddle_tpu_torch.ops.kernels import lstm as lk

PHASES = ('inputs wait', 'phase A', 'prefetch issue', 'dg wait', 'product',
          'butterfly+dx+barrier')

# (anchor, replacement) pairs that put the marks in; mk[i] is the cycle
# count at mark i of a step
MARKS = [
    ('namespace {\n\nconstexpr int kRows',
     '__device__ long long g_cycles[8];\nnamespace {\n\nconstexpr int kRows'),
    ('  for (int t = steps - 1; t >= 0; --t) {\n    const int s = t & 1;',
     '  long long cyc[6] = {0, 0, 0, 0, 0, 0}, mk[7];\n'
     '  for (int t = steps - 1; t >= 0; --t) {\n    mk[0] = clock64();\n'
     '    const int s = t & 1;'),
    ('    if (tid == 0) mbar_expect(bar, step_bytes);\n',
     '    if (tid == 0) mbar_expect(bar, step_bytes);\n    mk[1] = clock64();\n'),
    ('    if (t > 0) prefetch(t - 1, s ^ 1);\n    cp_async_commit();\n',
     '    mk[2] = clock64();\n    if (t > 0) prefetch(t - 1, s ^ 1);\n'
     '    cp_async_commit();\n    mk[3] = clock64();\n'),
    ('    mbar_wait(bar, ((steps - 1 - t) >> 1) & 1);\n',
     '    mbar_wait(bar, ((steps - 1 - t) >> 1) & 1);\n    mk[4] = clock64();\n'),
    ('    prod = warp_sums<V>(&acc[0][0], lane);\n',
     '    mk[5] = clock64();\n    prod = warp_sums<V>(&acc[0][0], lane);\n'),
    ('    __syncthreads();\n  }\n',
     '    __syncthreads();\n    mk[6] = clock64();\n'
     '    for (int i = 0; i < 6; ++i) cyc[i] += mk[i + 1] - mk[i];\n  }\n'
     '  if (blockIdx.x == 0 && tid == 0)\n'
     '    for (int i = 0; i < 6; ++i) g_cycles[i] = cyc[i];\n'),
]
# dx stored in phase A, right after the sends, instead of after phase B
DX_IN_PHASE_A = [
    ('    if (owner && b < batch) {\n      T* const xo = dx',
     '    if (false) {\n      T* const xo = dx'),
    ('      keep = (1.f - m) * dh_tot;\n',
     '      keep = (1.f - m) * dh_tot;\n      if (b < batch) {\n'
     '        T* const xo = dx + ((size_t)t * batch + b) * d4 + j;\n'
     '        for (int gate = 0; gate < 4; ++gate)\n'
     '          xo[gate * d] = Cvt<T>::from_f(dg[gate]);\n      }\n'),
]
VARIANTS = {
    'marked': [],
    'dx_in_phase_a': DX_IN_PHASE_A,
    'no_prefetch': [('    if (t > 0) prefetch(t - 1, s ^ 1);\n',
                     '    if (t < 0) prefetch(t - 1, s ^ 1);\n')],
    'no_product': [
        ('    if (kw + UW <= resident) {\n      walk_product<T, UW, true>',
         '    if (t < 0) {\n      walk_product<T, UW, true>'),
        ('    } else {  // some of these rows stream from L2\n      walk_product',
         '    } else if (t < 0) {\n      walk_product')],
}


TAIL = ('\nextern "C" int walk_cycles(long long* out) {\n'
        '  return (int)cudaMemcpyFromSymbol(out, g_cycles, '
        '6 * sizeof(long long));\n}\n')


def build_variants():
    """{name: ctypes library}, the variants compiled in parallel."""
    libs = {}
    for name, (lib, _) in profile_variants.build_variants(
            'profile_lstm_walk', 'lstm_bwd.cu',
            {name: MARKS + extra for name, extra in VARIANTS.items()},
            TAIL).items():
        lib.lstm_bwd_with_cluster.argtypes = [ctypes.c_void_p] * 11 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.walk_cycles.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit('profile_lstm_walk: needs a CUDA card')
    print(profile_variants.card_line(), flush=True)
    libs = build_variants()
    b, t, d = chip_smoke.LSTM_BATCH, chip_smoke.LSTM_MAX_LEN, \
        chip_smoke.STACKED_LSTM['hid_dim']
    xs, w, bias, h0, c0, mask, dhs, dcs = chip_smoke._lstm_inputs(
        torch.float32, b, t, d, False, chip_smoke.SEED + 6)
    hs, cs, acts = lk.lstm_fwd(xs, w, bias, h0, c0, mask)
    dx, dh0, dc0 = torch.empty_like(acts), torch.empty_like(h0), \
        torch.empty_like(c0)
    db_part = torch.empty((-(-b // 4), 4 * d), device='cuda')
    print('walk f32 B=%d T=%d D=%d; cycles a step of each phase, thread 0 of '
          'CTA 0: %s' % (b, t, d, ', '.join(PHASES)), flush=True)
    for name, lib in libs.items():
        for n in (1, 2, 4, 8):
            def run():
                rc = lib.lstm_bwd_with_cluster(
                    w.data_ptr(), mask.data_ptr(), acts.data_ptr(),
                    cs.data_ptr(), c0.data_ptr(), dhs.data_ptr(),
                    dcs.data_ptr(), dx.data_ptr(), dh0.data_ptr(),
                    dc0.data_ptr(), db_part.data_ptr(), t, b, d, 0, n,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError('walk launch failed: CUDA error %d'
                                       % rc)
            ms = chip_smoke._time_ms(run)
            cycles = (ctypes.c_longlong * 6)()
            if lib.walk_cycles(cycles):
                raise RuntimeError('reading the cycle counts failed')
            per = [c / t for c in cycles]
            print('%-12s N=%d %.4f ms (%.2f us a step); %s; sum %.0f' %
                  (name, n, ms, 1e3 * ms / t,
                   ', '.join('%.0f' % c for c in per), sum(per)), flush=True)
    _, dw_fn, _, _, _, _ = lk._kernels_bwd()
    for dtype in (torch.float32, torch.bfloat16):
        xs_, w_, h0_, dhs_ = (x.to(dtype) for x in (xs, w, h0, dhs))
        hs_, cs_, acts_ = lk.lstm_fwd(xs_, w_, bias, h0_, c0, mask)
        dx_, _, _, dbp = lk._launch_walk(w_, mask, acts_, cs_, h0_, c0, dhs_,
                                         dcs)
        line = []
        for splits in (4, 8, 16, 32, 64):
            part = torch.empty((splits, d, 4 * d), device='cuda')
            dw = torch.empty((d, 4 * d), device='cuda')
            db = torch.empty((1, 4 * d), device='cuda')

            def run_dw():
                rc = dw_fn(hs_.data_ptr(), h0_.data_ptr(), dx_.data_ptr(),
                           dbp.data_ptr(), part.data_ptr(), dw.data_ptr(),
                           db.data_ptr(), t, b, d, splits,
                           0 if dtype == torch.float32 else 1,
                           torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError('dW launch failed: CUDA error %d' % rc)
            line.append('%d: %.4f ms' % (splits, chip_smoke._time_ms(run_dw)))
        print('dW %s B=%d T=%d D=%d by split-K slices (CUDA events): %s' %
              (str(dtype)[6:], b, t, d, ', '.join(line)), flush=True)


if __name__ == '__main__':
    main()
