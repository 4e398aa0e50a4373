#!/usr/bin/env python3
"""Where the LSTM forward kernel's time goes, step by step, on one CUDA card.

    python3 profile_lstm_fwd.py     # from the repository root

Builds copies of ``paddle_tpu_torch/csrc/lstm_fwd.cu`` into ``build/`` with
``clock64()`` marks around the phases of the kernel's step loop (thread 0 of
CTA 0 adds up the cycles of each phase over all steps), and runs them at the
stacked-LSTM slice's shape (f32, B=128, T=64, D=128, full lengths, no
activations saved) with clusters of each size the kernel's plan takes:

- ``marked``: the kernel as it is, marks only;
- ``stores_deferred``: step t's hs and cs stored after step t+1's product
  instead of right after step t's sends;
- ``x_from_global``: x_t and the mask read from global memory in the gate
  math, with no copies into the stage (the old kernel's way);
- ``no_product``: without the product (wrong results: it prices the
  product by its absence);
- ``unroll_4``: the product's loop unrolled 4 times instead of 8;
- ``pipelined``: the product in batches of 4 rounds, the next batch's
  loads issued before the current batch's FMAs;
- ``accurate_math``: sigmoid and tanh from ``expf``, a full division and
  ``tanhf`` instead of ``__expf`` and ``__fdividef`` (the error against the
  plain version is printed);
- ``one_cta_per_sm``: each CTA asks for at least 120,000 bytes of shared
  memory, so that no SM holds two CTAs.

For each it prints the call's time (CUDA events, median of 20 samples of
10 calls) and the cycles a step of each phase: the wait for h, the
product, the butterfly, the gate math (the stage's wait included), the
sends, and the stores and copies; and, on the global timer, the CTAs'
entry skew, set-up and loop times and how many SMs held two CTAs or more.
Prints the card's name, power limit and clocks first.  The marks are
placed by matching lines of the source (``profile_variants.py``): a change
there that moves them makes this script stop with the line it did not
find.
"""

import ctypes
import sys

import torch

import profile_variants  # (puts the repository on the path first)
import chip_smoke  # its input and timing helpers
from paddle_tpu_torch.ops.kernels import lstm as lk

PHASES = ('h wait', 'product', 'butterfly', 'gate math', 'sends',
          'stores+copies')

# (anchor, replacement) pairs that put the marks in; mk[i] is the cycle
# count at mark i of a step
MARKS = [
    ('namespace {\n\nconstexpr int kRows',
     '__device__ long long g_cycles[8];\n__device__ long long g_cta[4096][4];\n'
     '__device__ __forceinline__ long long gtime() {\n  long long v;\n'
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));\n  return v;\n}\n'
     'namespace {\n\nconstexpr int kRows'),
    ('  const int tid = threadIdx.x;\n  const int lane = tid & 31;',
     '  const long long gt0 = gtime();\n'
     '  const int tid = threadIdx.x;\n  const int lane = tid & 31;'),
    ('  for (int t = 0; t < steps; ++t) {\n    const int s = t & 1;',
     '  const long long gt1 = gtime();\n'
     '  long long cyc[6] = {0, 0, 0, 0, 0, 0}, mk[7];\n'
     '  for (int t = 0; t < steps; ++t) {\n    mk[0] = clock64();\n'
     '    const int s = t & 1;'),
    ('    if (t > 0) mbar_wait(bar_base + 8 * s, ((t - 1) >> 1) & 1);\n',
     '    if (t > 0) mbar_wait(bar_base + 8 * s, ((t - 1) >> 1) & 1);\n'
     '    mk[1] = clock64();\n'),
    ('    // k-groups g and g ^ 2', '    mk[2] = clock64();\n'
     '    // k-groups g and g ^ 2'),
    ('    // the gate math of (row r, unit j)', '    mk[3] = clock64();\n'
     '    // the gate math of (row r, unit j)'),
    ('    if (send) {  // unit j', '    mk[4] = clock64();\n'
     '    if (send) {  // unit j'),
    ('    if (live) {\n      const size_t row',
     '    mk[5] = clock64();\n    if (live) {\n      const size_t row'),
    ('    if (send) prefetch(t + 1, s ^ 1);\n  }\n',
     '    if (send) prefetch(t + 1, s ^ 1);\n    mk[6] = clock64();\n'
     '    for (int i = 0; i < 6; ++i) cyc[i] += mk[i + 1] - mk[i];\n  }\n'
     '  if (blockIdx.x == 0 && tid == 0)\n'
     '    for (int i = 0; i < 6; ++i) g_cycles[i] = cyc[i];\n'),
    # each CTA's entry, loop start and loop end (global timer, ns) and SM
    ('  // no CTA leaves while',
     '  if (tid == 0 && blockIdx.x < 4096) {\n    unsigned sm;\n'
     '    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
     '    g_cta[blockIdx.x][0] = gt0;\n    g_cta[blockIdx.x][1] = gt1;\n'
     '    g_cta[blockIdx.x][2] = gtime();\n    g_cta[blockIdx.x][3] = sm;\n'
     '  }\n  // no CTA leaves while'),
]
# hs and cs of step t stored after step t+1's product (and after the loop
# for the last step); the slice's timing saves no activations
STORES_DEFERRED = [
    ('  for (int t = 0; t < steps; ++t) {\n',
     '  float p_h = 0.f, p_c = 0.f;\n  size_t p_row = 0;\n  bool p_ok = false;\n'
     '  for (int t = 0; t < steps; ++t) {\n'),
    ('    // k-groups g and g ^ 2',
     '    if (p_ok) {\n      hs[p_row * d + j] = Cvt<T>::from_f(p_h);\n'
     '      cs[p_row * d + j] = p_c;\n    }\n    // k-groups g and g ^ 2'),
    ('    if (live) {\n      const size_t row = (size_t)t * batch + b;\n'
     '      hs[row * d + j] = Cvt<T>::from_f(h_out);\n'
     '      cs[row * d + j] = c_out;\n',
     '    p_ok = live;\n    p_row = (size_t)t * batch + b;\n    p_h = h_out;\n'
     '    p_c = c_out;\n    if (live) {\n      const size_t row = p_row;\n'),
    ('  // no CTA leaves while',
     '  if (p_ok) {\n    hs[p_row * d + j] = Cvt<T>::from_f(p_h);\n'
     '    cs[p_row * d + j] = p_c;\n  }\n  // no CTA leaves while'),
]
X_FROM_GLOBAL = [
    ('    if (lane < X_CHUNKS)\n      cp_async16',
     '    if (lane < 0)\n      cp_async16'),
    ('    if (lane < kRows)\n      cp_async4', '    if (lane < 0)\n      cp_async4'),
    ('    const float gc = (Cvt<T>::to_f(xst[xi]) + acc[0]) + bc;\n'
     '    const float gi = (Cvt<T>::to_f(xst[GATE + xi]) + acc[1]) + bi;\n'
     '    const float gf = (Cvt<T>::to_f(xst[2 * GATE + xi]) + acc[2]) + bf;\n'
     '    const float go = (Cvt<T>::to_f(xst[3 * GATE + xi]) + acc[3]) + bo;\n'
     '    const float m = mst[r];\n',
     '    const size_t xrow = (size_t)t * batch + (live ? b : 0);\n'
     '    const T* const xg = xs + xrow * d4 + j;\n'
     '    const float gc = (Cvt<T>::to_f(__ldg(xg)) + acc[0]) + bc;\n'
     '    const float gi = (Cvt<T>::to_f(__ldg(xg + d)) + acc[1]) + bi;\n'
     '    const float gf = (Cvt<T>::to_f(__ldg(xg + 2 * d)) + acc[2]) + bf;\n'
     '    const float go = (Cvt<T>::to_f(__ldg(xg + 3 * d)) + acc[3]) + bo;\n'
     '    const float m = live ? __ldg(mask + xrow) : 0.f;\n'
     '    (void)xst;\n    (void)mst;\n'),
]
ACCURATE_MATH = [
    ('  return __fdividef(1.f, 1.f + __expf(-x));\n',
     '  return 1.f / (1.f + expf(-x));\n'),
    ('  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);\n',
     '  return tanhf(x);\n'),
]
ONE_CTA_PER_SM = [
    ('  if (!plan_fwd<T>(d, n, &fl->plan)) return cudaErrorInvalidValue;\n',
     '  if (!plan_fwd<T>(d, n, &fl->plan)) return cudaErrorInvalidValue;\n'
     '  if (fl->plan.smem < 120000) fl->plan.smem = 120000;\n'),
]
# the product's resident rounds in batches of 4, the next batch's loads
# issued before the current batch's FMAs
PIPELINED = [
    ('#pragma unroll 8\n    for (; k < resident; k += kGroups)\n'
     '      fma16(acc, hb[k], Cvt<T>::lds4(w_unit + (size_t)k * ld));\n',
     '    {\n'
     '      constexpr int P = 4;\n'
     '      const int nb = (resident - g + kGroups - 1) / kGroups / P;\n'
     '      float4 hc[P], wc[P];\n'
     '#pragma unroll\n'
     '      for (int p = 0; p < P; ++p) {\n'
     '        hc[p] = hb[k + p * kGroups];\n'
     '        wc[p] = Cvt<T>::lds4(w_unit + (size_t)(k + p * kGroups) * ld);\n'
     '      }\n'
     '#pragma unroll 2\n'
     '      for (int bi = 0; bi < nb; ++bi) {\n'
     '        const int kn = bi + 1 < nb ? k + P * kGroups : k;\n'
     '        float4 hn[P], wn[P];\n'
     '#pragma unroll\n'
     '        for (int p = 0; p < P; ++p) {\n'
     '          hn[p] = hb[kn + p * kGroups];\n'
     '          wn[p] = Cvt<T>::lds4(w_unit + (size_t)(kn + p * kGroups) * ld);\n'
     '        }\n'
     '#pragma unroll\n'
     '        for (int p = 0; p < P; ++p) fma16(acc, hc[p], wc[p]);\n'
     '#pragma unroll\n'
     '        for (int p = 0; p < P; ++p) {\n'
     '          hc[p] = hn[p];\n'
     '          wc[p] = wn[p];\n'
     '        }\n'
     '        k += P * kGroups;\n'
     '      }\n'
     '    }\n'
     '    for (; k < resident; k += kGroups)\n'
     '      fma16(acc, hb[k], Cvt<T>::lds4(w_unit + (size_t)k * ld));\n'),
]
VARIANTS = {
    'marked': [],
    'stores_deferred': STORES_DEFERRED,
    'x_from_global': X_FROM_GLOBAL,
    'no_product': [
        ('    for (; k < resident; k += kGroups)\n',
         '    for (; t < 0 && k < resident; k += kGroups)\n'),
        ('    for (; k < d; k += kGroups) {', '    for (; t < 0 && k < d; k += kGroups) {')],
    'unroll_4': [('#pragma unroll 8\n    for (; k < resident;',
                  '#pragma unroll 4\n    for (; k < resident;')],
    'accurate_math': ACCURATE_MATH,
    'pipelined': PIPELINED,
    'one_cta_per_sm': ONE_CTA_PER_SM,
}


TAIL = ('\nextern "C" int fwd_cycles(long long* out) {\n'
        '  return (int)cudaMemcpyFromSymbol(out, g_cycles, '
        '6 * sizeof(long long));\n}\n'
        'extern "C" int fwd_ctas(long long* out, int n) {\n'
        '  return (int)cudaMemcpyFromSymbol(out, g_cta, '
        '4 * n * sizeof(long long));\n}\n')


def build_variants():
    """{name: ctypes library}, the variants compiled in parallel; prints
    each one's registers."""
    libs = {}
    for name, (lib, log) in profile_variants.build_variants(
            'profile_lstm_fwd', 'lstm_fwd.cu',
            {name: MARKS + extra for name, extra in VARIANTS.items()},
            TAIL).items():
        regs = [ln.split('Used')[1].split(',')[0].strip()
                for ln in log.splitlines() if 'Used' in ln]
        print('build: %s registers (bf16, f32): %s' % (name, ', '.join(regs)),
              flush=True)
        lib.lstm_fwd_with_cluster.argtypes = [ctypes.c_void_p] * 9 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.fwd_cycles.argtypes = [ctypes.c_void_p]
        lib.fwd_ctas.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = lib
    return libs


def cta_spread(lib, n, b):
    """The last launch's CTAs on the global timer: entry skew, set-up (entry
    to loop) and loop times, and the SMs that held more than one CTA."""
    ctas = -(-b // 4) * n
    raw = (ctypes.c_longlong * (4 * ctas))()
    if lib.fwd_ctas(raw, ctas):
        raise RuntimeError('reading the CTA times failed')
    rows = [raw[4 * i:4 * i + 4] for i in range(ctas)]
    start = min(r[0] for r in rows)
    setup = sorted((r[1] - r[0]) / 1e3 for r in rows)
    loop = sorted((r[2] - r[1]) / 1e3 for r in rows)
    sms = [r[3] for r in rows]
    shared = len([s for s in set(sms) if sms.count(s) > 1])
    return ('CTAs on the global timer (us): entry skew %.1f, set-up median %.1f '
            'max %.1f, loop min %.1f median %.1f max %.1f, last end %.1f after '
            'the first entry; %d SMs, %d holding 2+ CTAs' %
            (max(r[0] for r in rows) / 1e3 - start / 1e3, setup[len(setup) // 2],
             setup[-1], loop[0], loop[len(loop) // 2], loop[-1],
             (max(r[2] for r in rows) - start) / 1e3, len(set(sms)), shared))


def main():
    if not torch.cuda.is_available():
        sys.exit('profile_lstm_fwd: needs a CUDA card')
    print(profile_variants.card_line(), flush=True)
    libs = build_variants()
    b, t, d = chip_smoke.LSTM_BATCH, chip_smoke.LSTM_MAX_LEN, \
        chip_smoke.STACKED_LSTM['hid_dim']
    xs, w, bias, h0, c0, mask, _, _ = chip_smoke._lstm_inputs(
        torch.float32, b, t, d, False, chip_smoke.SEED + 6)
    want = lk.lstm_fwd_plain(xs, w, bias, h0, c0, mask, save_acts=False)
    hs, cs = torch.empty_like(want[0]), torch.empty_like(want[1])
    print('forward f32 B=%d T=%d D=%d (the library picks N=%d); cycles a step '
          'of each phase, thread 0 of CTA 0: %s' %
          (b, t, d, lk.fwd_cluster(b, d, torch.float32), ', '.join(PHASES)),
          flush=True)
    for name, lib in libs.items():
        for n in lk.fwd_cluster_sizes(d, torch.float32):
            def run():
                rc = lib.lstm_fwd_with_cluster(
                    xs.data_ptr(), w.data_ptr(), bias.data_ptr(),
                    h0.data_ptr(), c0.data_ptr(), mask.data_ptr(),
                    hs.data_ptr(), cs.data_ptr(), None, t, b, d, 0, n,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError('forward launch failed: CUDA error %d'
                                       % rc)
            ms = chip_smoke._time_ms(run)
            err = max((hs - want[0]).abs().max().item(),
                      (cs - want[1]).abs().max().item())
            cycles = (ctypes.c_longlong * 6)()
            if lib.fwd_cycles(cycles):
                raise RuntimeError('reading the cycle counts failed')
            per = [c / t for c in cycles]
            print('%-15s N=%d %.4f ms (%.2f us a step), max|d| vs plain %.2g; '
                  '%s; sum %.0f' %
                  (name, n, ms, 1e3 * ms / t, err,
                   ', '.join('%.0f' % c for c in per), sum(per)), flush=True)
            print('%-15s N=%d %s' % (name, n, cta_spread(lib, n, b)),
                  flush=True)


if __name__ == '__main__':
    main()
