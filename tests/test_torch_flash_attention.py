"""The PyTorch port's flash-attention forward (paddle_tpu_torch/ops/kernels)
held against the JAX package's Pallas kernel, run in interpret mode on the
CPU as tests/test_pallas_flash.py runs it, and LSE against a float64 numpy
log-sum-exp.  The CUDA kernel itself runs only on the card (chip_smoke.py);
here its argument validation is checked to raise rather than fall back.

Tolerance 1e-5 in f32: both sides compute the same masked softmax in f32,
differing only in summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from paddle_tpu.parallel.context_parallel import \
    dense_attention as jax_dense_attention

from paddle_tpu_torch.ops import attention_ops
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.parallel.context_parallel import dense_attention

B, L, H, D = 2, 48, 4, 16
LQ_CROSS, LK_CROSS = 24, 50
TOL = 1e-5


def _qkv(seed, lq, lk, d=D):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, lq, H, d)).astype('float32')
    k = rng.standard_normal((B, lk, H, d)).astype('float32')
    v = rng.standard_normal((B, lk, H, d)).astype('float32')
    return q, k, v


def _np_lse(q, k, causal, lens, scale):
    """float64 log-sum-exp per [B, Lq, H]; -1e30 for fully masked rows."""
    s = np.einsum('bqhd,bkhd->bhqk', q.astype('float64'),
                  k.astype('float64')) * scale
    lq, lk = q.shape[1], k.shape[1]
    cols = np.arange(lk)
    limit = np.full(B, lk) if lens is None else np.asarray(lens)
    mask = (cols[None, :] < limit[:, None])[:, None, None, :]
    if causal:
        mask = mask & (cols[None, :] <= np.arange(lq)[:, None])[None, None]
    mask = np.broadcast_to(mask, s.shape)
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    m_safe = np.where(np.isfinite(m), m, 0.0)
    total = np.exp(s - m_safe).sum(-1)
    with np.errstate(divide='ignore'):
        lse = np.where(mask.any(-1), m[..., 0] + np.log(total), -1e30)
    return lse.transpose(0, 2, 1)


@pytest.mark.parametrize('shape', ['self', 'cross'])
@pytest.mark.parametrize('with_lens', [False, True])
@pytest.mark.parametrize('causal', [False, True])
def test_plain_matches_pallas_kernel(causal, with_lens, shape):
    lq, lk = (L, L) if shape == 'self' else (LQ_CROSS, LK_CROSS)
    q, k, v = _qkv(7, lq, lk)
    lens = np.array([40, 13], np.int32) if with_lens else None
    ref = jax_flash(q, k, v, causal=causal, seq_lengths=lens, block_q=16,
                    block_k=16)
    o, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, seq_lengths=lens)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(),
                               _np_lse(q, k, causal, lens, D**-0.5),
                               rtol=TOL, atol=TOL)


def test_fully_masked_row_is_zero():
    q, k, v = _qkv(3, L, L)
    lens = np.array([0, 30], np.int32)
    ref = np.asarray(jax_flash(q, k, v, seq_lengths=lens, block_q=16,
                               block_k=16))
    o, lse = fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), seq_lengths=lens)
    assert np.all(ref[0] == 0.0)
    assert torch.all(o[0] == 0.0)
    assert torch.all(lse[0] == -1e30)
    np.testing.assert_allclose(o.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse[1].numpy(),
                               _np_lse(q, k, False, lens, D**-0.5)[1],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize('causal', [False, True])
def test_dense_attention_matches_jax(causal):
    q, k, v = _qkv(5, LQ_CROSS, LK_CROSS)
    lens = np.array([0, 21], np.int32)
    ref = jax_dense_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal,
                              seq_lengths=lens)
    out = dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal,
                          seq_lengths=lens)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_cpu_wrapper_takes_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, L, L))
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=True, scale=0.3)
    want = fa.flash_attention_plain(q, k, v, causal=True, scale=0.3)[0]
    assert torch.equal(got, want)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize('case', ['head_dim', 'dtype', 'layout', 'device',
                                  'dv', 'alignment'])
def test_kernel_path_raises_instead_of_falling_back(case, monkeypatch):
    def no_build():
        raise AssertionError('validation must reject before any build')

    monkeypatch.setattr(fa, '_kernel', no_build)
    d = 24 if case == 'head_dim' else 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, L, L, d))
    if case == 'dtype':
        q, k, v = q.half(), k.half(), v.half()
    elif case == 'layout':
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == 'dv':
        v = torch.zeros(B, L, H, 32)
    elif case == 'alignment':  # contiguous, but 4 bytes past a float4
        q = torch.cat([torch.zeros(1), q.reshape(-1)])[1:].view(q.shape)
        assert q.is_contiguous() and q.data_ptr() % 16 == 4
    with pytest.raises(ValueError):
        fa._launch(q, k, v, False, 1.0, None)


def test_pick_impl_routes_by_shape():
    class Op(object):
        def __init__(self, impl):
            self.attrs = {'impl': impl}

    q = torch.zeros(1, 4, 2, 64)
    assert attention_ops._pick_impl(Op('auto'), q, q) == 'kernel'
    assert attention_ops._pick_impl(Op('pallas'), q, q) == 'kernel'
    assert attention_ops._pick_impl(Op('dense'), q, q) == 'dense'
    assert attention_ops._pick_impl(Op('auto'), q,
                                    torch.zeros(1, 4, 2, 32)) == 'dense'
    odd = torch.zeros(1, 4, 2, 24)
    assert attention_ops._pick_impl(Op('auto'), odd, odd) == 'kernel'
    with pytest.raises(NotImplementedError):
        attention_ops._pick_impl(Op('ring'), q, q)


def test_lowering_masks_by_k_seqlen_sideband():
    """K's @SEQLEN side-band propagates through the reshape ops the layer
    adds and reaches the kernel's lens; Q's does not mask."""
    import paddle_tpu_torch.fluid as fluid
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        q, k, v = (fluid.layers.data(n, [L, H * D]) for n in 'qkv')
        out = fluid.layers.flash_attention(q, k, v, num_heads=H, causal=True)
    qa, ka, va = _qkv(9, L, L)
    lens = np.array([5, 31], np.int32)
    feed = {'q': qa.reshape(B, L, H * D), 'k': ka.reshape(B, L, H * D),
            'v': va.reshape(B, L, H * D), 'k@SEQLEN': lens,
            'q@SEQLEN': np.array([1, 1], np.int32)}
    got, = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=[out], scope=fluid.Scope())
    want = np.asarray(jax_flash(qa, ka, va, causal=True, seq_lengths=lens,
                                block_q=16, block_k=16))
    np.testing.assert_allclose(got, want.reshape(B, L, H * D), rtol=TOL,
                               atol=TOL)


def test_lowering_unsupported_head_dim_raises_on_kernel_path(monkeypatch):
    """A head_dim the kernel does not take goes to the kernel's wrapper, not
    to dense attention: on the kernel path (the branch a CUDA tensor takes,
    forced here) it raises instead of running the plain version."""
    import paddle_tpu_torch.fluid as fluid

    def no_build():
        raise AssertionError('validation must reject before any build')

    def kernel_path(q, k, v, causal=False, scale=None, seq_lengths=None):
        return fa._launch(q, k, v, causal, 1.0, None)

    monkeypatch.setattr(fa, '_kernel', no_build)
    monkeypatch.setattr(fa, 'flash_attention_fwd', kernel_path)
    d = 24
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        q, k, v = (fluid.layers.data(n, [L, H * d]) for n in 'qkv')
        out = fluid.layers.flash_attention(q, k, v, num_heads=H)
    qa, ka, va = _qkv(4, L, L, d)
    feed = {'q': qa.reshape(B, L, H * d), 'k': ka.reshape(B, L, H * d),
            'v': va.reshape(B, L, H * d)}
    with pytest.raises(ValueError, match='head_dim 24'):
        fluid.Executor(fluid.CPUPlace()).run(prog, feed=feed,
                                             fetch_list=[out],
                                             scope=fluid.Scope())
