"""The PyTorch port's flash-attention backward (paddle_tpu_torch/ops/kernels)
held against the JAX package on the CPU: ``jax.vjp`` of the Pallas kernel,
run in interpret mode as tests/test_pallas_flash.py runs it, against both
``flash_attention_bwd_plain`` and ``torch.func.vjp`` through the port's
``FlashAttention`` autograd.Function.  The CUDA kernels run only on the card
(chip_smoke.py); here their argument validation is checked to raise before
any build, and their 3xTF32 arithmetic is emulated in plain PyTorch with the
forward's emulation helpers (tests/test_torch_flash_attention.py: each f32
operand split into two TF32 parts, each MMA's sum rounded toward zero) and
held to the plain version, beside the whole-loop-chain counterfactual.

Tolerance 2e-5 in f32: both sides recompute P from the log-sum-exp and sum
the same products in f32, in another order, over up to 50 columns.
"""

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

from paddle_tpu_torch.ops.kernels import flash_attention as fa

from test_torch_flash_attention import CHIP_TOL, _mma, _mma3, _product, _tf32

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


# --- the backward kernels' 3xTF32 arithmetic, emulated on the CPU ----------

EMU_B, EMU_H, EMU_L, EMU_D = 2, 2, 128, 64
BWD_CHAIN = 4     # the kernels' k-steps of dQ, dK, dV per f32 partial
LOG2E = 1.4426950408889634


def _emulate_bwd(q, k, v, o, lse, do, causal, lens, chain=BWD_CHAIN):
    """The two kernels on [B, L, H, D] f32, in their order of operations:
    delta = rowsum(dO * O); the dQ kernel's S = Q K^T and dP = dO V^T, the
    dK/dV kernel's S^T = K Q^T and dP^T = V dO^T (one chain of MMAs over D,
    A the resident rows); P = exp2(S * scale * log2 e - LSE * log2 e), 0
    where masked; dS = P (dP - delta); then dQ += dS K, dV += P^T dO and
    dK += dS^T Q in partials of ``chain`` k-steps (None: one chain over the
    whole loop).  A group the kernels skip (causal, past lens) holds P = 0
    and adds an exact 0 here.  (dQ, dK, dV, delta) as the kernels write
    them."""
    qh, kh, vh, oh, doh = (x.permute(0, 2, 1, 3) for x in (q, k, v, o, do))
    b, _, lq, d = qh.shape
    lk = kh.shape[2]
    scale = d**-0.5
    delta = (doh * oh).sum(-1)          # [B, H, Lq]
    lse2 = lse.transpose(1, 2) * LOG2E  # [B, H, Lq], log2 units
    masked = ~fa._mask(b, lq, lk, causal,
                       None if lens is None else torch.as_tensor(lens),
                       'cpu')           # [B, 1, Lq, Lk]

    s = _product(qh, kh.transpose(-1, -2), 3)
    dp = _product(doh, vh.transpose(-1, -2), 3)
    p = torch.exp2((s * scale * LOG2E - lse2[..., None]).masked_fill(
        masked, float('-inf')))
    dq = _product(p * (dp - delta[..., None]), kh, 3, chain) * scale

    st = _product(kh, qh.transpose(-1, -2), 3)
    dpt = _product(vh, doh.transpose(-1, -2), 3)
    pt = torch.exp2((st * scale * LOG2E - lse2[..., None, :]).masked_fill(
        masked.transpose(-1, -2), float('-inf')))
    dv = _product(pt, doh, 3, chain)
    dk = _product(pt * (dpt - delta[..., None, :]), qh, 3, chain) * scale
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv)) + (
        delta.transpose(1, 2), )


def _emu_bwd_inputs(causal=False, with_lens=False, length=EMU_L):
    """q, k, v, O, LSE (the plain forward's), dO and lens at the emulation's
    size."""
    rng = np.random.RandomState(17)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (EMU_B, length, EMU_H, EMU_D)).astype('float32')) for _ in range(4))
    lens = np.array([0, 77], np.int32) if with_lens else None
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                      seq_lengths=lens)
    return q, k, v, o, lse, do, lens


@pytest.mark.parametrize('with_lens', [False, True])
@pytest.mark.parametrize('causal', [False, True])
def test_bwd_3xtf32_emulation_matches_plain(causal, with_lens):
    """dQ, dK, dV in the kernels' split arithmetic, slice and partial order,
    with delta from O, agree with flash_attention_bwd_plain within
    chip_smoke.py's f32 tolerance (scaled by max(1, max|plain|)), and delta
    with bwd_delta."""
    q, k, v, o, lse, do, lens = _emu_bwd_inputs(causal, with_lens)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        seq_lengths=lens)
    got = _emulate_bwd(q, k, v, o, lse, do, causal, lens)
    for name, g, w in zip(('dq', 'dk', 'dv', 'delta'), got,
                          want + (fa.bwd_delta(o, do), )):
        tol = CHIP_TOL * max(1.0, w.abs().max().item())
        err = (g - w).abs().max().item()
        assert err <= tol, (name, err, tol)
    if with_lens:  # row 0 has length 0: every gradient of it is 0
        for g in got[:3]:
            assert torch.all(g[0] == 0)


def _pull_toward_zero(got, want):
    """The mean of got's error toward zero against ``want`` (float64), over
    the mean |want|."""
    return ((want - got.double()) * want.sign()).mean().item() / \
        want.abs().mean().item()


def test_bwd_partials_keep_grads_from_drifting_toward_zero():
    """The counterfactual of the fresh partials, at the Transformer slice's
    length 256: one chain of MMAs over the whole loop into dK and dV (and
    dQ) lets the round-toward-zero sums pull them toward zero at least twice
    as far as partials of BWD_CHAIN k-steps added in f32, against the
    gradients in float64 (2.1-2.6x here: the partials keep the drift of
    the 24-MMA chains of S and dP over D)."""
    q, k, v, o, lse, do, _ = _emu_bwd_inputs(length=256)
    qh, kh, vh, doh = (x.double().permute(0, 2, 1, 3) for x in (q, k, v, do))
    p = torch.softmax(qh @ kh.transpose(-1, -2) * EMU_D**-0.5, -1)
    delta = (doh * (p @ vh)).sum(-1, keepdim=True)
    ds = p * (doh @ vh.transpose(-1, -2) - delta) * EMU_D**-0.5
    want = tuple(x.permute(0, 2, 1, 3) for x in (
        ds @ kh, ds.transpose(-1, -2) @ qh, p.transpose(-1, -2) @ doh))
    parts = _emulate_bwd(q, k, v, o, lse, do, False, None)
    chained = _emulate_bwd(q, k, v, o, lse, do, False, None, chain=None)
    for name, gp, gc, w in zip(('dq', 'dk', 'dv'), parts, chained, want):
        pull_parts = _pull_toward_zero(gp, w)
        pull_chained = _pull_toward_zero(gc, w)
        assert pull_chained > 0 and pull_chained >= 2 * abs(pull_parts), \
            (name, pull_chained, pull_parts)


def _mma_bf16(c, a, b):
    """The kernels' bf16 path for an f32 A (P or dS) and a B exact in TF32
    (a widened bf16): small*big, then big*big, two MMAs."""
    a_big = _tf32(a)
    return _mma(_mma(c, _tf32(a - a_big), b), a_big, b)


def test_bf16_products_equal_3xtf32_when_b_is_exact():
    """With B exact in TF32, the term big*small that the bf16 path leaves
    out adds an exact 0: its two MMAs (A f32) and its one MMA (A and B
    exact, as S and dP) give the 3xTF32 sums bit for bit, over a chain of
    k-steps."""
    rng = np.random.RandomState(5)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        'float32'))
    bf16 = lambda *s: f32(*s).to(torch.bfloat16).float()
    a, a_exact, b = f32(16, 64), bf16(16, 64), bf16(64, 8)
    for a_ in (a, a_exact):
        c3 = c2 = c1 = torch.zeros(16, 8)
        for k0 in range(0, 64, 8):
            step_a, step_b = a_[:, k0:k0 + 8], b[k0:k0 + 8]
            c3 = _mma3(c3, step_a, step_b, 3)
            c2 = _mma_bf16(c2, step_a, step_b)
            c1 = _mma(c1, step_a, step_b)
        assert torch.equal(c2, c3)
        if a_ is a_exact:
            assert torch.equal(c1, c3)
