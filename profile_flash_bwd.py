#!/usr/bin/env python3
"""The flash-attention backward kernels against variants of their design, on
one CUDA card.

    python3 profile_flash_bwd.py     # from the repository root

Builds ``paddle_tpu_torch/csrc/flash_attention_bwd.cu`` as it is and edited
copies of it and of ``tf32_mma.cuh`` into ``build/flash_bwd_variants/<name>/``
(one ``nvcc`` each, all started together):

- ``as_is``: the source unchanged;
- ``unrolled``: the loop over a tile's groups of 4 k-steps unrolled;
- ``warps8``: 8 warps x 16 rows a CTA (128 Q or K rows; run at D=64 only,
  where O still fits a K/V stage);
- ``tiles32``: 32-row streamed tiles at every head_dim (64 below D=128);
- ``unrounded``: the small part of the 3xTF32 split left unrounded, for the
  MMA to read the f32 register as TF32.

For each it prints ptxas's registers and spills of every instantiation,
then, at the Transformer slice's shape (B=16, H=8, L=256, D=64; f32 and
bf16, causal and not, and f32 at D=128), each variant's largest error
against the plain version (scaled by max(1, max|plain|)) and the time of
one dQ launch (delta included) and one dK/dV launch (CUDA events, median of
20 samples of 10 calls), in two turns of alternating order.  A variant that
disagrees with the plain version beyond chip_smoke.py's tolerance makes the
script exit 1 at the end.  Prints the card's name and power limit first.
The edits match lines of the source: a change there that moves them makes
this script stop with the text it did not find.
"""

import concurrent.futures
import ctypes
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (its input and timing helpers)
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

OUT = os.path.join(REPO, 'build', 'flash_bwd_variants')

_GROUP_LOOP = '#pragma unroll 1\n    for (int j2 = 0; j2 < NT; j2 += CHAIN) {'
_EVEN_COPY = '''  static_assert(ROWS * PER_ROW % NUM_THREADS == 0, "uneven tile copy");
#pragma unroll
  for (int i = 0; i < ROWS * PER_ROW / NUM_THREADS; ++i) {
    const int idx = threadIdx.x + i * NUM_THREADS;
'''
_ANY_COPY = '''#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += NUM_THREADS) {
'''
KERNEL, HEADER = 'flash_attention_bwd.cu', 'tf32_mma.cuh'
# variant: [(file, text, replacement, count)]
VARIANTS = {
    'as_is': [],
    'unrolled': [(KERNEL, _GROUP_LOOP,
                  _GROUP_LOOP.replace('unroll 1', 'unroll'), 2)],
    'warps8': [
        (KERNEL, 'constexpr int BLOCK_M = 64;', 'constexpr int BLOCK_M = 128;',
         1),
        (KERNEL, 'constexpr int NUM_WARPS = 4;',
         'constexpr int NUM_WARPS = 8;', 1),
        (KERNEL, '  static_assert(2 * N_ELEMS >= M_ELEMS, "O does not fit a '
         'K/V stage");\n', '', 1),
        (KERNEL, _EVEN_COPY, _ANY_COPY, 1)],
    'tiles32': [(KERNEL, 'BLOCK_N = D >= 128 ? 32 : 64;', 'BLOCK_N = 32;', 1),
                (KERNEL, _EVEN_COPY, _ANY_COPY, 1)],
    'unrounded': [
        (HEADER, 'small = (__float_as_uint(x - __uint_as_float(big)) + '
         '0x1000u) & TF32_MASK;',
         'small = __float_as_uint(x - __uint_as_float(big));', 1)],
}


def _build_variant(name):
    """(name, library path or None, nvcc output)"""
    files = {}
    for fname in (KERNEL, HEADER):
        with open(os.path.join(_build.CSRC, fname)) as f:
            files[fname] = f.read()
    for fname, old, new, count in VARIANTS[name]:
        if files[fname].count(old) != count:
            sys.exit('profile_flash_bwd: %s: expected %d of %r in %s' %
                     (name, count, old, fname))
        files[fname] = files[fname].replace(old, new)
    vdir = os.path.join(OUT, name)  # the kernel finds its header beside it
    os.makedirs(vdir, exist_ok=True)
    for fname, text in files.items():
        with open(os.path.join(vdir, fname), 'w') as f:
            f.write(text)
    path = os.path.join(vdir, KERNEL)
    lib = os.path.join(vdir, 'libflash_attention_bwd.so')
    proc = subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS +
                          ['-o', lib, path], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return name, lib if proc.returncode == 0 else None, proc.stdout


def _entry_points(lib):
    lib = ctypes.CDLL(lib)
    return (fa._bind(lib.flash_attention_dq, 9),
            fa._bind(lib.flash_attention_dkv, 9))


def _dq(fns, q, k, v, o, do, lse, causal, scale):
    b, lq, h, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((b, lq, h), dtype=torch.float32, device=q.device)
    rc = fns[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), None, dq.data_ptr(),
                delta.data_ptr(), b, lq, k.shape[1], h, d, scale,
                int(causal), fa._DTYPE_CODES[q.dtype],
                torch.cuda.current_stream().cuda_stream)
    chip_smoke.check(rc == 0, 'flash_attention_dq launch failed: %d' % rc)
    return dq, delta


def _dkv(fns, q, k, v, do, lse, delta, causal, scale):
    b, lq, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = fns[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), None, dk.data_ptr(),
                dv.data_ptr(), b, lq, k.shape[1], h, d, scale, int(causal),
                fa._DTYPE_CODES[q.dtype],
                torch.cuda.current_stream().cuda_stream)
    chip_smoke.check(rc == 0, 'flash_attention_dkv launch failed: %d' % rc)
    return dk, dv


def main():
    card = chip_smoke.phase_device()
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(_build_variant, VARIANTS))
    libs = {}
    for name, lib, log in built:
        chip_smoke.check(lib is not None, '%s does not build:\n%s' %
                         (name, log[-4000:]))
        for fn, (regs, spill) in sorted(chip_smoke._ptxas_table(log).items()):
            m = re.search(r'(dq|dkv)_kernelI(f|13__nv_bfloat16)Li(\d+)E', fn)
            if m:
                print('build: %-9s %-3s %-4s D=%-3s %3d registers, %d spill '
                      'bytes' % (name, m.group(1),
                                 'f32' if m.group(2) == 'f' else 'bf16',
                                 m.group(3), regs, spill))
        libs[name] = _entry_points(lib)
    sys.stdout.flush()

    b, h, seq = chip_smoke.BATCH, 8, 256
    bad = []
    for d, dtype in ((64, torch.float32), (64, torch.bfloat16),
                     (128, torch.float32)):
        scale = d**-0.5
        q, k, v = chip_smoke._qkv(b, seq, seq, h, d, dtype, chip_smoke.SEED)
        do = chip_smoke._qkv(b, seq, seq, h, d, dtype, chip_smoke.SEED + 7)[0]
        for causal in (False, True):
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                causal=causal)
            names = [n for n in libs if d == 64 or n != 'warps8']
            for turn, order in enumerate((names, names[::-1])):
                for name in order:
                    fns = libs[name]
                    dq, delta = _dq(fns, q, k, v, o, do, lse, causal, scale)
                    dk, dv = _dkv(fns, q, k, v, do, lse, delta, causal, scale)
                    torch.cuda.synchronize()
                    err = max((g.float() - w.float()).abs().max().item() /
                              max(1.0, w.float().abs().max().item())
                              for g, w in zip((dq, dk, dv), want))
                    if err > chip_smoke.TOL[dtype]:
                        bad.append((name, str(dtype), d, causal))
                    t_dq = chip_smoke._time_ms(
                        lambda: _dq(fns, q, k, v, o, do, lse, causal, scale))
                    t_dkv = chip_smoke._time_ms(
                        lambda: _dkv(fns, q, k, v, do, lse, delta, causal,
                                     scale))
                    print('variants: %-9s %s B=%d L=%d H=%d D=%d causal=%d '
                          'turn %d: dQ %.4f + dK/dV %.4f = %.4f ms (events), '
                          'max scaled err %.3g [%s]' %
                          (name, str(dtype)[6:], b, seq, h, d, causal,
                           turn + 1, t_dq, t_dkv, t_dq + t_dkv, err, card),
                          flush=True)
    chip_smoke.check(not bad, 'variants disagree with the plain version: %s'
                     % bad)


if __name__ == '__main__':
    main()
