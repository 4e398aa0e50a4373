"""The PyTorch port's flash-attention forward (paddle_tpu_torch/ops/kernels)
held against the JAX package's Pallas kernel, run in interpret mode on the
CPU as tests/test_pallas_flash.py runs it, and LSE against a float64 numpy
log-sum-exp.  The CUDA kernel itself runs only on the card (chip_smoke.py);
here its argument validation is checked to raise rather than fall back, and
its 3xTF32 arithmetic (each f32 operand split into two TF32 parts, three
products per matrix product, each MMA's sum rounded toward zero, P V summed
in partials of 4 k-steps) is emulated in plain PyTorch and held to the plain
version, beside the 1xTF32 and the unpartitioned-chain counterfactuals.

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
                                  'dv', 'alignment', 'alignment_bf16'])
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
    elif case == 'alignment_bf16':  # 8 bytes past a 16-byte cp.async chunk
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        flat = torch.cat([torch.zeros(4, dtype=torch.bfloat16),
                          q.reshape(-1)])
        q = flat[4:].view(q.shape)
        assert q.is_contiguous() and q.data_ptr() % 16 == 8
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


# --- the forward kernel's 3xTF32 arithmetic, emulated on the CPU ----------

EMU_B, EMU_H, EMU_L, EMU_D = 2, 2, 128, 64
EMU_BLOCK_K = 64      # the kernel's K/V tile at D=64
PV_CHAIN = 4          # the kernel's k-steps of P V per f32 partial
CHIP_TOL = 1e-4       # chip_smoke.py's f32 kernel-vs-plain tolerance
_TF32_LOW = 0x1fff    # the 13 mantissa bits TF32 drops


def _tf32(x):
    """x (f32) rounded to TF32 by bit operations on its mantissa: to nearest
    (ties away from zero, as cvt.rna), the 13 low bits cleared."""
    bits = x.contiguous().view(torch.int32) + 0x1000
    return (bits & ~_TF32_LOW).view(torch.float32)


def _mma(c, a, b):
    """One m16n8k8 MMA step, c + a @ b over one 8-wide k-step: the products
    of TF32 operands summed exactly (in f64) with c, the sum rounded to f32
    toward zero, as the tensor cores round it."""
    exact = c.double() + a.double() @ b.double()
    near = exact.float()
    return torch.where(near.double().abs() > exact.abs(),
                       torch.nextafter(near, torch.zeros_like(near)), near)


def _mma3(c, a, b, terms):
    """c + a @ b over one k-step as the kernel issues it: x = big + small,
    big = x rounded to TF32 and small = x - big rounded to TF32; terms=3 is
    small*big, big*small, then big*big (3xTF32), terms=1 big*big alone
    (1xTF32); each an MMA of its own."""
    a_big, b_big = _tf32(a), _tf32(b)
    if terms == 3:
        c = _mma(c, _tf32(a - a_big), b_big)
        c = _mma(c, a_big, _tf32(b - b_big))
    return _mma(c, a_big, b_big)


def _product(a, b, terms, chain=None, c=None):
    """a @ b in k-steps of 8.  chain=None runs every k-step's MMAs into c
    (zeros when absent); chain=n sums each n k-steps in a fresh partial
    from 0 and adds it to c in f32 with round-to-nearest."""
    c = torch.zeros(a.shape[:-1] + b.shape[-1:]) if c is None else c
    steps = range(0, a.shape[-1], 8)
    for s0 in range(0, a.shape[-1], 8 * (chain or len(steps))):
        part = torch.zeros_like(c) if chain else c
        for k0 in range(s0, min(s0 + 8 * (chain or len(steps)),
                                a.shape[-1]), 8):
            part = _mma3(part, a[..., k0:k0 + 8], b[..., k0:k0 + 8, :],
                         terms)
        c = c + part if chain else part
    return c


def _emulate_fwd(q, k, v, causal, lens, terms, chain=PV_CHAIN):
    """The kernel's forward on [B, L, H, D] f32: S = Q K^T in one chain of
    MMAs, the scale (times log2 e) on the scores, online softmax in exp2
    units over EMU_BLOCK_K-column tiles, and O += P V in partials of
    ``chain`` k-steps (None: one chain into O over the whole K loop);
    ``terms``-product TF32 throughout.  (O, LSE) as the kernel returns
    them."""
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))  # [B, H, L, D]
    b, h, lq, d = qh.shape
    lk = kh.shape[2]
    scale_log2 = d**-0.5 * 1.4426950408889634
    limit = torch.full((b, ), lk) if lens is None else torch.as_tensor(lens)
    rows = torch.arange(lq)[:, None]
    m = torch.full((b, h, lq, 1), -1e30)
    l = torch.zeros(b, h, lq, 1)
    acc = torch.zeros(b, h, lq, d)
    for k0 in range(0, lk, EMU_BLOCK_K):
        cols = torch.arange(k0, min(k0 + EMU_BLOCK_K, lk))[None, :]
        s = _product(qh, kh[:, :, cols[0]].transpose(-1, -2), terms)
        s = s * scale_log2
        mask = cols[None, None] >= limit[:, None, None, None]
        if causal:
            mask = mask | (cols > rows)[None, None]
        s = s.masked_fill(mask, float('-inf'))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = _product(p, vh[:, :, cols[0]], terms, chain, acc * alpha)
        m = m_new
    live = l > 0
    o = torch.where(live, acc / l.clamp_min(1e-30), 0.0)
    lse = torch.where(live, m * 0.6931471805599453 +
                      torch.log(l.clamp_min(1e-30)), -1e30)
    return o.permute(0, 2, 1, 3), lse[..., 0].transpose(1, 2)


def _emu_inputs(with_lens=False, length=EMU_L):
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (EMU_B, length, EMU_H, EMU_D)).astype('float32')) for _ in range(3))
    return q, k, v, (np.array([0, 77], np.int32) if with_lens else None)


def _emulation_errors(causal, with_lens, terms):
    """max |emulation - flash_attention_plain| over O and LSE, each over
    CHIP_TOL * max(1, max|plain|)."""
    q, k, v, lens = _emu_inputs(with_lens)
    po, plse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        seq_lengths=lens)
    eo, el = _emulate_fwd(q, k, v, causal, lens, terms)
    rel = []
    for got, want in ((eo, po), (el, plse)):
        tol = CHIP_TOL * max(1.0, want.abs().max().item())
        rel.append((got - want).abs().max().item() / tol)
    return max(rel)


@pytest.mark.parametrize('with_lens', [False, True])
@pytest.mark.parametrize('causal', [False, True])
def test_3xtf32_emulation_matches_plain(causal, with_lens):
    """The kernel's split arithmetic (three TF32 products per matrix
    product) agrees with the f32 plain version within chip_smoke.py's f32
    tolerance."""
    assert _emulation_errors(causal, with_lens, terms=3) <= 1.0


@pytest.mark.parametrize('with_lens', [False, True])
@pytest.mark.parametrize('causal', [False, True])
def test_1xtf32_errs_tenfold_more_than_3xtf32(causal, with_lens):
    """The counterfactual: one TF32 product per matrix product (no small
    parts) errs at least 10 times more on the same inputs."""
    three = _emulation_errors(causal, with_lens, terms=3)
    one = _emulation_errors(causal, with_lens, terms=1)
    assert one >= 10 * three, (one, three)


def _pull_toward_zero(o, q, k, v):
    """The mean of O's error toward zero against a float64 softmax of the
    same inputs (non-causal, no lengths), over the mean |O|."""
    qh, kh, vh = (x.double().permute(0, 2, 1, 3) for x in (q, k, v))
    want = torch.softmax(qh @ kh.transpose(-1, -2) * EMU_D**-0.5,
                         -1) @ vh
    want = want.permute(0, 2, 1, 3)
    return ((want - o.double()) * want.sign()).mean().item() / \
        want.abs().mean().item()


def test_pv_partials_keep_o_from_drifting_toward_zero():
    """The counterfactual of the P V partials, at the Transformer slice's
    length 256: one chain of MMAs into O over the whole K loop lets the
    round-toward-zero sums pull O toward zero at least twice as far as
    partials of PV_CHAIN k-steps added to O in f32 (3.6x here; the f32
    plain version's pull is ~1e-8 of |O|, either sign)."""
    q, k, v, _ = _emu_inputs(length=256)
    parts = _pull_toward_zero(
        _emulate_fwd(q, k, v, False, None, 3)[0], q, k, v)
    chained = _pull_toward_zero(
        _emulate_fwd(q, k, v, False, None, 3, chain=None)[0], q, k, v)
    assert chained > 0 and chained >= 2 * abs(parts), (chained, parts)


def test_mma_sum_rounds_toward_zero():
    """_mma's sum is the f32 next to the exact one on the side of zero."""
    one_ulp = 2.0**-23
    a = torch.tensor([[1.0, 0.75 * one_ulp] + [0.0] * 6])
    b = torch.zeros(8, 1)
    b[:2] = 1.0
    assert _mma(torch.zeros(1, 1), a, b).item() == 1.0
    assert _mma(torch.zeros(1, 1), -a, b).item() == -1.0
    assert _mma(torch.full((1, 1), 2.0), a, b).item() == 3.0


def test_tf32_rounding_by_bits():
    """_tf32 rounds to nearest (ties away from zero) and clears 13 bits."""
    one_ulp = 2.0**-10  # TF32's ulp at 1.0
    x = torch.tensor([1.0 + 0.49 * one_ulp, 1.0 + 0.5 * one_ulp,
                      -(1.0 + 0.5 * one_ulp), 1.0 + 0.51 * one_ulp,
                      3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + one_ulp, -(1.0 + one_ulp),
                         1.0 + one_ulp, 3.0])
    assert torch.equal(_tf32(x), want)
    assert not (_tf32(torch.randn(1000)).view(torch.int32) & _TF32_LOW).any()
