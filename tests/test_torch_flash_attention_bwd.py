"""The PyTorch port's flash-attention backward (paddle_tpu_torch/ops/kernels)
held against the JAX package on the CPU: ``jax.vjp`` of the Pallas kernel,
run in interpret mode as tests/test_pallas_flash.py runs it, against both
``flash_attention_bwd_plain`` and ``torch.func.vjp`` through the port's
``FlashAttention`` autograd.Function.  The CUDA kernels run only on the card
(chip_smoke.py); here their argument validation is checked to raise before
any build.

Tolerance 2e-5 in f32: both sides recompute P from the log-sum-exp and sum
the same products in f32, in another order, over up to 50 columns.
"""

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

from paddle_tpu_torch.ops.kernels import flash_attention as fa

B, H, D = 2, 2, 16
TOL = 2e-5
SHAPES = {'self': (40, 40), 'cross': (20, 50)}  # Lq no multiple of 16


def _inputs(seed, lq, lk):
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.standard_normal(s).astype('float32')
    return f32(B, lq, H, D), f32(B, lk, H, D), f32(B, lk, H, D), \
        f32(B, lq, H, D)


def _jax_grads(q, k, v, do, causal, lens):
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, seq_lengths=lens,
                                  block_q=16, block_k=16), q, k, v)
    return [np.asarray(g) for g in vjp(do)]


@pytest.mark.parametrize('shape', ['self', 'cross'])
@pytest.mark.parametrize('lens', [None, (0, 13)])
@pytest.mark.parametrize('causal', [False, True])
def test_backward_matches_pallas_vjp(causal, lens, shape):
    lq, lk = SHAPES[shape]
    q, k, v, do = _inputs(3, lq, lk)
    lens = None if lens is None else np.array(lens, np.int32)
    want = _jax_grads(q, k, v, do, causal, lens)

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      seq_lengths=lens)
    plain = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                         causal=causal, seq_lengths=lens)
    out, vjp = torch.func.vjp(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=causal,
                                           seq_lengths=lens), tq, tk, tv)
    np.testing.assert_allclose(out.numpy(), o.numpy(), rtol=0, atol=0)
    through_function = vjp(tdo)
    for name, w, p, f in zip('qkv', want, plain, through_function):
        np.testing.assert_allclose(p.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg='plain d' + name)
        np.testing.assert_allclose(f.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg='vjp d' + name)
    if lens is not None:  # row 0 has length 0: no query sees any column
        for g in plain:
            assert torch.all(g[0] == 0)


def test_cpu_path_leaves_launch_counters_unchanged():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(5, 40, 40))
    before = (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
    _, vjp = torch.func.vjp(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=True), q, k, v)
    vjp(do)
    o, lse = fa.flash_attention_fwd(q, k, v)
    fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV) == before


@pytest.mark.parametrize('case', ['head_dim', 'dtype', 'layout', 'dv',
                                  'alignment', 'do_shape', 'do_dtype',
                                  'lse_dtype', 'lse_shape'])
def test_backward_kernel_path_raises_before_any_build(case, monkeypatch):
    def no_build():
        raise AssertionError('validation must reject before any build')

    monkeypatch.setattr(fa, '_bwd_kernels', no_build)
    d = 24 if case == 'head_dim' else D
    rng = np.random.RandomState(1)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype('float32'))
    q, k, v, do = mk(B, 40, H, d), mk(B, 40, H, d), mk(B, 40, H, d), \
        mk(B, 40, H, d)
    o, lse = torch.zeros_like(q), torch.zeros(B, 40, H)
    if case == 'dtype':
        q, k, v, o, do = (t.half() for t in (q, k, v, o, do))
    elif case == 'layout':
        do = do.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == 'dv':
        v = torch.zeros(B, 40, H, 32)
    elif case == 'alignment':  # contiguous, but 4 bytes past a float4
        o = torch.cat([torch.zeros(1), o.reshape(-1)])[1:].view(o.shape)
        assert o.is_contiguous() and o.data_ptr() % 16 == 4
    elif case == 'do_shape':
        do = do[:, :20].contiguous()
    elif case == 'do_dtype':
        do = do.double()
    elif case == 'lse_dtype':
        lse = lse.double()
    elif case == 'lse_shape':
        lse = lse[:, :20].contiguous()
    with pytest.raises(ValueError):
        fa._launch_bwd(q, k, v, o, lse, do, False, 1.0, None)
