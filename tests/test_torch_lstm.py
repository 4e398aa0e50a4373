"""The PyTorch port's LSTM kernels' plain versions (paddle_tpu_torch/ops/
kernels/lstm.py) held against the JAX package on the CPU: the Pallas kernels
of paddle_tpu/ops/pallas/lstm.py run in interpret mode, as
tests/test_pallas_lstm.py runs them, forward (hs, cs, the saved activations)
and ``jax.vjp`` (dx, dW, db, dh0, dc0).  The CUDA kernels run only on the
card (chip_smoke.py); here their argument validation is checked to raise
before any build, and the CPU path to leave the launch counters alone.

Tolerances: the forward 1e-5, as tests/test_pallas_lstm.py holds the kernel
to its scan (the same f32 recurrence, the h . W sums in another order); the
backward rtol 2e-4, atol 2e-5, as that file holds the kernel's gradients:
dW and db sum over every (step, row) in another order.  In bf16 (x, w, h
and the activations rounded to bf16 at every step, c and the sums in f32)
2e-2, scaled by max(1, max|want|) for the backward: a sum taken in another
order can round h or a dgate to the neighbouring bf16 value (2^-8
relative), and that carries through the steps and into dW's sums.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import lstm as pallas_lstm

from paddle_tpu_torch.fluid import flags
from paddle_tpu_torch.ops.kernels import lstm as lk

FWD_TOL = {'float32': 1e-5, 'bfloat16': 2e-2}
BWD_TOL = {'float32': (2e-4, 2e-5), 'bfloat16': (2e-2, 2e-2)}
CASES = [(8, 12, 128, 'float32'), (16, 5, 256, 'float32'),
         (8, 12, 128, 'bfloat16')]


def _inputs(b, t, d, seed=0):
    """xs [T, B, 4D], w, bias [1, 4D], nonzero h0/c0, a mask with a length-0
    row and a full-length row, and cotangents dhs, dcs."""
    rng = np.random.RandomState(seed)
    f32 = lambda scale, *s: (rng.standard_normal(s) * scale).astype('float32')
    xs, w, bias = f32(0.3, t, b, 4 * d), f32(0.2, d, 4 * d), f32(0.1, 1, 4 * d)
    h0, c0 = f32(0.5, b, d), f32(0.5, b, d)
    lengths = rng.randint(1, t + 1, size=(b, ))
    lengths[0], lengths[1] = 0, t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype('float32')
    dhs, dcs = f32(1.0, t, b, d), f32(1.0, t, b, d)
    return xs, w, bias, h0, c0, mask, dhs, dcs


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# x, w, h0 and dhs in the working dtype; bias, c0, mask and dcs stay f32
_LOW = (0, 1, 3, 6)


def _cast(arrays, dtype):
    """The arrays for JAX and for torch, the _LOW ones in ``dtype`` (both
    round the same f32 values to nearest even)."""
    jx = [jnp.asarray(a, dtype if i in _LOW else jnp.float32)
          for i, a in enumerate(arrays)]
    tt = [t.to(getattr(torch, dtype)) if i in _LOW else t
          for i, t in enumerate(_torch(*arrays))]
    return jx, tt


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize('b,t,d,dtype', CASES)
def test_plain_forward_matches_pallas(b, t, d, dtype):
    inputs = _inputs(b, t, d)
    (xs, w, bias, h0, c0, mask, _, _), targs = _cast(inputs, dtype)
    want = pallas_lstm._fwd_impl(xs, w, bias, h0, c0, mask.reshape(t, 1, b),
                                 interpret=True, save_acts=True)
    got = lk.lstm_fwd_plain(*targs[:6])
    for name, g, wnt in zip(('hs', 'cs', 'acts'), got, want):
        assert g.dtype == getattr(torch, str(wnt.dtype)), name
        np.testing.assert_allclose(_f32(g), _f32(wnt), rtol=FWD_TOL[dtype],
                                   atol=FWD_TOL[dtype], err_msg=name)
    # the length-0 row keeps h0 and c0 at every step
    assert torch.equal(got[0][:, 0], targs[3][0].expand(t, d))
    hs, cs = lk.lstm_fused_tm(*targs[:6])
    assert torch.equal(hs, got[0]) and torch.equal(cs, got[1])


@pytest.mark.parametrize('b,t,d,dtype', CASES)
def test_plain_backward_matches_pallas_vjp(b, t, d, dtype):
    (xs, w, bias, h0, c0, mask, dhs, dcs), targs = _cast(
        _inputs(b, t, d, seed=1), dtype)
    _, vjp = jax.vjp(
        lambda *a: pallas_lstm.lstm_fused_tm(*a, mask=mask, interpret=True),
        xs, w, bias, h0, c0)
    want = vjp((dhs, dcs))

    txs, tw, tb, th0, tc0, tmask, tdhs, tdcs = targs
    hs, cs, acts = lk.lstm_fwd_plain(txs, tw, tb, th0, tc0, tmask)
    plain = lk.lstm_bwd_plain(tw, tmask, acts, cs, hs, th0, tc0, tdhs, tdcs)
    _, tvjp = torch.func.vjp(
        lambda *a: lk.lstm_fused_tm(*a, mask=tmask), txs, tw, tb, th0, tc0)
    through_function = tvjp((tdhs, tdcs))
    rtol, atol = BWD_TOL[dtype]
    scaled = dtype == 'bfloat16'
    for name, wnt, p, f in zip(('dx', 'dW', 'db', 'dh0', 'dc0'), want, plain,
                               through_function):
        assert p.shape == wnt.shape and f.shape == wnt.shape, name
        assert f.dtype == getattr(torch, str(wnt.dtype)), name
        tol = atol * max(1.0, float(np.abs(_f32(wnt)).max())) if scaled \
            else atol
        np.testing.assert_allclose(_f32(p), _f32(wnt), rtol=rtol, atol=tol,
                                   err_msg='plain ' + name)
        np.testing.assert_allclose(_f32(f), _f32(wnt), rtol=rtol, atol=tol,
                                   err_msg='vjp ' + name)
    # the length-0 row: no gate gradient at any step, dh0/dc0 pass through
    assert torch.all(plain[0][:, 0] == 0)
    np.testing.assert_allclose(_f32(plain[3][0]), _f32(tdhs[:, 0].float(
    ).sum(0)), rtol=FWD_TOL[dtype], atol=FWD_TOL[dtype])


def test_lstm_core_hands_the_backward_plain_tensors(monkeypatch):
    """Under torch.func.vjp LSTMCore's backward receives wrapped tensors,
    which have no data pointer: what it hands on to the backward wrapper
    must be plain tensors."""
    real = lk.lstm_bwd
    seen = []

    def probe(*args):
        seen.extend(t.data_ptr() for t in args)
        return real(*args)

    monkeypatch.setattr(lk, 'lstm_bwd', probe)
    xs, w, bias, h0, c0, mask, dhs, dcs = _torch(*_inputs(8, 4, 32, seed=2))
    _, vjp = torch.func.vjp(lambda xs, w: lk.lstm_fused_tm(
        xs, w, bias, h0, c0, mask), xs, w)
    dxs, dw = vjp((dhs, dcs))
    assert len(seen) == 9 and dxs.abs().max() > 0 and dw.abs().max() > 0


def test_no_grad_call_skips_the_activations(monkeypatch):
    """Where no gradient is asked for, the forward runs without writing the
    [T, B, 4D] activations (the JAX package's primal path)."""
    calls = []
    real = lk.lstm_fwd_plain

    def probe(xs, w, bias, h0, c0, mask, save_acts=True):
        calls.append(save_acts)
        return real(xs, w, bias, h0, c0, mask, save_acts)

    monkeypatch.setattr(lk, 'lstm_fwd_plain', probe)
    args = _torch(*_inputs(8, 4, 32, seed=3)[:6])
    with torch.no_grad():
        lk.lstm_fused_tm(*args)
    torch.func.vjp(lambda xs: lk.lstm_fused_tm(xs, *args[1:]), args[0])
    assert calls == [False, True]


def test_cpu_path_leaves_launch_counters_unchanged():
    before = (lk.LAUNCHES_FWD, lk.LAUNCHES_BWD, lk.LAUNCHES_DW)
    xs, w, bias, h0, c0, mask, dhs, dcs = _torch(*_inputs(8, 4, 32, seed=4))
    _, vjp = torch.func.vjp(lambda xs: lk.lstm_fused_tm(
        xs, w, bias, h0, c0, mask), xs)
    vjp((dhs, dcs))
    hs, cs, acts = lk.lstm_fwd(xs, w, bias, h0, c0, mask)
    lk.lstm_bwd(w, mask, acts, cs, hs, h0, c0, dhs, dcs)
    assert (lk.LAUNCHES_FWD, lk.LAUNCHES_BWD, lk.LAUNCHES_DW) == before


@pytest.mark.parametrize('case', ['device', 'width', 'dtype', 'mixed_dtype',
                                  'layout', 'bias_dtype', 'mask_shape',
                                  'h0_shape', 'cluster'])
def test_forward_kernel_path_raises_before_any_build(case, monkeypatch):
    def no_build():
        raise AssertionError('validation must reject before any build')

    monkeypatch.setattr(lk, '_kernel_fwd', no_build)
    xs, w, bias, h0, c0, mask = _torch(
        *_inputs(8, 4, 48 if case == 'width' else 32, seed=5)[:6])
    if case == 'dtype':
        xs, w, h0 = xs.half(), w.half(), h0.half()
    elif case == 'mixed_dtype':
        w = w.to(torch.bfloat16)
    elif case == 'layout':
        xs = xs.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == 'bias_dtype':
        bias = bias.double()
    elif case == 'mask_shape':
        mask = mask[:2].contiguous()
    elif case == 'h0_shape':
        h0 = h0[:4].contiguous()
    if case == 'cluster':  # not a cluster size the kernels take
        with pytest.raises(ValueError, match='cluster'):
            lk._launch_fwd(xs, w, bias, h0, c0, mask, True, cluster=3)
        return
    with pytest.raises(ValueError):
        lk._launch_fwd(xs, w, bias, h0, c0, mask, True)


@pytest.mark.parametrize('kind', ['fwd', 'walk'])
def test_cluster_sizes_are_the_plans_verdicts(kind, monkeypatch):
    # the library's verdicts: -1 refused, 0 taken with W streaming, 1 held
    asked = []

    def fit(d, dtype, n):
        asked.append((d, dtype, n))
        return {1: -1, 2: 1, 4: 0, 8: -1}[n]

    if kind == 'fwd':
        monkeypatch.setattr(lk, '_kernel_fwd', lambda: (None, None, fit))
        sizes = lk.fwd_cluster_sizes(288, torch.bfloat16)
    else:
        monkeypatch.setattr(lk, '_kernels_bwd',
                            lambda: (None, None, 4, None, 32, fit))
        sizes = lk.walk_cluster_sizes(288, torch.bfloat16)
    assert sizes == [2, 4]
    assert asked == [(288, 1, n) for n in (1, 2, 4, 8)]


@pytest.mark.parametrize('case', ['device', 'acts_dtype', 'cs_dtype',
                                  'dhs_shape', 'dcs_layout'])
def test_backward_kernel_path_raises_before_any_build(case, monkeypatch):
    def no_build():
        raise AssertionError('validation must reject before any build')

    monkeypatch.setattr(lk, '_kernels_bwd', no_build)
    xs, w, bias, h0, c0, mask, dhs, dcs = _torch(*_inputs(8, 4, 32, seed=6))
    hs, cs, acts = lk.lstm_fwd_plain(xs, w, bias, h0, c0, mask)
    if case == 'acts_dtype':
        acts = acts.to(torch.bfloat16)
    elif case == 'cs_dtype':
        cs = cs.double()
    elif case == 'dhs_shape':
        dhs = dhs[:2].contiguous()
    elif case == 'dcs_layout':
        dcs = dcs.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        lk._launch_bwd(w, mask, acts, cs, hs, h0, c0, dhs, dcs)


def test_kernel_takes_the_documented_range():
    assert lk.kernel_takes(128, 128, torch.float32)
    assert lk.kernel_takes(32, 1, torch.bfloat16)
    assert lk.kernel_takes(512, 13, torch.float32)
    assert not lk.kernel_takes(48, 8, torch.float32)
    assert not lk.kernel_takes(1024, 8, torch.float32)
    assert not lk.kernel_takes(128, 8, torch.float16)


def test_fused_lstm_flag_rejects_a_typo():
    with pytest.raises(ValueError):
        flags.FLAGS.fused_lstm = 'off'
    assert flags.FLAGS.fused_lstm == 'auto'


def test_misaligned_inputs_are_copied_for_the_kernels():
    """The kernels copy rows in 16-byte pieces: the wrapper hands them an
    aligned copy of a tensor whose data is not 16-byte aligned."""
    t = torch.arange(9, dtype=torch.float32)[1:]
    assert t.data_ptr() % 16 and lk._aligned(t).data_ptr() % 16 == 0
    assert torch.equal(lk._aligned(t), t)
    u = torch.zeros(8)
    assert lk._aligned(u) is u


# --- the backward kernels' arithmetic, emulated on the CPU -----------------

CHIP_TOL = 1e-4   # chip_smoke.py's f32 kernel-vs-plain tolerance (LSTM_TOL)
DW_TILE_K = 32    # the dW kernel's K tile: one fresh partial a tile
ROWS = 4          # batch rows of one walk cluster
_TF32_LOW = 0x1fff


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
    """c + a @ b over one k-step as the kernel issues it: terms=3 is
    small*big, big*small, then big*big (3xTF32), terms=1 big*big alone (bf16
    operands, exact in TF32)."""
    a_big, b_big = _tf32(a), _tf32(b)
    if terms == 3:
        c = _mma(c, _tf32(a - a_big), b_big)
        c = _mma(c, a_big, _tf32(b - b_big))
    return _mma(c, a_big, b_big)


def _emulate_dw(h_prev, dg16, splits, terms, chain=True):
    """lstm_bwd_dw's dW = h_prev^T . dg16 ([K, D] and [K, 4D] f32): K in
    ``splits`` slices of whole DW_TILE_K tiles; in a slice each tile's
    k-steps run into a fresh partial added to the slice's f32 sum
    (chain=False: every k-step of the slice into one accumulator); the
    slices summed in order."""
    k_total = h_prev.shape[0]
    k_per = -(-k_total // splits)
    k_per = -(-k_per // DW_TILE_K) * DW_TILE_K
    a = h_prev.t().contiguous()
    dw = torch.zeros(h_prev.shape[1], dg16.shape[1])
    for s0 in range(0, k_per * splits, k_per):
        acc = torch.zeros_like(dw)
        for t0 in range(s0, min(s0 + k_per, k_total), DW_TILE_K):
            part = torch.zeros_like(dw) if chain else acc
            for k0 in range(t0, min(t0 + DW_TILE_K, k_total), 8):
                part = _mma3(part, a[:, k0:k0 + 8], dg16[k0:k0 + 8], terms)
            acc = acc + part if chain else part
        dw = dw + acc
    return dw


def _dw_case(dtype, t=16, b=32, d=32):
    """(h_prev [T*B, D], dg16 [T*B, 4D], plain dW) from the plain forward
    and backward on seeded inputs, in f32."""
    (_, _, _, _, _, _, _, _), targs = _cast(_inputs(b, t, d, seed=7), dtype)
    xs, w, bias, h0, c0, mask, dhs, dcs = targs
    hs, cs, acts = lk.lstm_fwd_plain(xs, w, bias, h0, c0, mask)
    dx, dw, _, _, _ = lk.lstm_bwd_plain(w, mask, acts, cs, hs, h0, c0, dhs,
                                        dcs)
    h_prev = torch.cat([h0[None], hs[:-1]]).reshape(t * b, d).float()
    return h_prev, dx.reshape(t * b, 4 * d).float(), dw


@pytest.mark.parametrize('dtype,splits', [('float32', 1), ('float32', 4),
                                          ('bfloat16', 4)])
def test_dw_tensor_core_emulation_matches_plain(dtype, splits):
    """The dW kernel's arithmetic (3xTF32 for f32, one TF32 MMA for bf16,
    each MMA's sum rounded toward zero, a fresh partial a K tile, split-K
    slices summed in order) agrees with lstm_bwd_plain's dW within
    chip_smoke.py's f32 tolerance, scaled by max(1, max|plain|)."""
    h_prev, dg16, want = _dw_case(dtype)
    got = _emulate_dw(h_prev, dg16, splits, 3 if dtype == 'float32' else 1)
    tol = CHIP_TOL * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


def test_dw_partials_keep_dw_from_drifting_toward_zero():
    """The counterfactual of the fresh partials: one chain of MMAs over a
    whole K slice (512 rows, 64 k-steps) lets the round-toward-zero sums
    pull dW toward zero at least twice as far as a fresh partial a K tile
    added with round-to-nearest."""
    h_prev, dg16, _ = _dw_case('float32')
    want = h_prev.double().t() @ dg16.double()

    def pull(got):
        return ((want - got.double()) * want.sign()).mean().item() / \
            want.abs().mean().item()

    parts = pull(_emulate_dw(h_prev, dg16, 1, 3))
    chained = pull(_emulate_dw(h_prev, dg16, 1, 3, chain=False))
    assert chained > 0 and chained >= 2 * abs(parts), (chained, parts)


def _fma_chain(s, a, b):
    """s + a * b with one rounding to f32, as fmaf (the product of two f32
    values is exact in f64)."""
    return (s.double() + a.double() * b.double()).float()


def _emulate_walk(w, mask, acts, cs, h0, c0, dhs, dcs, n_ctas):
    """lstm_bwd's walk as the kernel splits it: batch rows in clusters of
    ROWS, each cluster's D units split over ``n_ctas`` ranks.  A rank computes
    the dgates of its units, the dg16 of all ranks is gathered, and a rank
    sums dg16 . W^T for its units as the kernel's lanes do: lane l walks n
    = l, l + 32, ... with fmaf, then a butterfly sums the 32 lanes.  Returns (dx, db, dh0, dc0), db summed over each cluster's rows in order
    and then over the clusters in order."""
    t_steps, b, d4 = acts.shape
    d = d4 // 4
    units = d // n_ctas
    wf = w.float()
    keep = torch.zeros(b, d)
    prod = torch.zeros(b, d)
    dc = torch.zeros(b, d)
    db_acc = torch.zeros(b, d4)
    dx = torch.zeros(t_steps, b, d4, dtype=w.dtype)
    lane = torch.arange(32)
    for t in reversed(range(t_steps)):
        dg16 = torch.zeros(b, d4)
        for rank in range(n_ctas):
            j = torch.arange(rank * units, (rank + 1) * units)
            cols = torch.cat([g * d + j for g in range(4)])
            a = acts[t][:, cols].float().reshape(b, 4, units)
            cand, ig, fg, og = a.unbind(1)
            c_prev = (c0 if t == 0 else cs[t - 1])[:, j].float()
            c_new = fg * c_prev + ig * cand
            tc = torch.tanh(c_new)
            m = mask[t][:, None]
            dh_tot = dhs[t][:, j].float() + (keep[:, j] + prod[:, j])
            dc_tot = dcs[t][:, j] + dc[:, j]
            dh_new = m * dh_tot
            dc_new = m * dc_tot + dh_new * og * (1 - tc * tc)
            dg = torch.cat([(dc_new * ig) * (1 - cand * cand),
                            (dc_new * cand) * ig * (1 - ig),
                            (dc_new * c_prev) * fg * (1 - fg),
                            dh_new * tc * og * (1 - og)], dim=1)
            dx[t][:, cols] = dg.to(w.dtype)
            db_acc[:, cols] += dg
            dg16[:, cols] = dg.to(w.dtype).float()
            keep[:, j] = (1 - m) * dh_tot
            dc[:, j] = (1 - m) * dc_tot + dc_new * fg
        # every rank now holds all of dg16: its units' sums, lane by lane
        for rank in range(n_ctas):
            j = torch.arange(rank * units, (rank + 1) * units)
            s = torch.zeros(32, b, units)
            for n0 in range(0, d4, 32):
                s = _fma_chain(s, dg16[:, n0 + lane].t()[:, :, None],
                               wf[j][:, n0 + lane].t()[:, None, :])
            for off in (16, 8, 4, 2, 1):
                s = s + s[lane ^ off]
            prod[:, j] = s[0]
    pad = -b % ROWS
    rows = torch.cat([db_acc, torch.zeros(pad, d4)]).reshape(-1, ROWS, d4)
    db = torch.zeros(1, d4)
    for cluster in rows:
        part = cluster[0]
        for r in range(1, ROWS):
            part = part + cluster[r]
        db = db + part
    return dx, db, (keep + prod).to(h0.dtype), dc


@pytest.mark.parametrize('n_ctas', [1, 2, 4])
def test_walk_cluster_emulation_matches_plain(n_ctas):
    """The walk as a cluster of ``n_ctas`` CTAs computes it agrees with
    lstm_bwd_plain (ragged rows: a length-0 row, a full row, a batch of 10
    that leaves the last cluster half empty) within chip_smoke.py's f32
    tolerance, and is bitwise the same at every cluster size: each (row,
    unit) sum runs in the same order whichever rank owns the unit."""
    b, t, d = 10, 12, 32
    xs, w, bias, h0, c0, mask, dhs, dcs = _torch(*_inputs(b, t, d, seed=8))
    hs, cs, acts = lk.lstm_fwd_plain(xs, w, bias, h0, c0, mask)
    args = (w, mask, acts, cs, h0, c0, dhs, dcs)
    got = _emulate_walk(*args, n_ctas)
    want = lk.lstm_bwd_plain(w, mask, acts, cs, hs, h0, c0, dhs, dcs)
    for name, g, wnt in zip(('dx', 'db', 'dh0', 'dc0'), got,
                            (want[0], want[2], want[3], want[4])):
        tol = CHIP_TOL * max(1.0, wnt.abs().max().item())
        assert (g - wnt).abs().max().item() <= tol, name
    assert torch.all(got[0][:, 0] == 0)  # the length-0 row
    if n_ctas > 1:
        for g, one in zip(got, _emulate_walk(*args, 1)):
            assert torch.equal(g, one)


def _emulate_fwd_cluster(xs, w, bias, h0, c0, mask, n_ctas):
    """lstm_fwd's kernel as it splits the recurrence: batch rows in clusters
    of ROWS (rows past B zero and masked), each cluster's D units split over
    ``n_ctas`` ranks, h gathered from every rank after each step.  A rank
    sums (row, gate, unit) over k as its lanes do: k-group g chains k = g,
    g + 4, ... with fmaf, and the butterfly adds (p0 + p2) + (p1 + p3); the
    gates are (x + sum) + bias.  The gate math runs on all units at once
    (torch's vectorised tanh and sigmoid can differ in the last bit with an
    element's place in a tensor; the kernel's are the same for every unit).
    Returns (hs, cs, acts)."""
    t_steps, b, d4 = xs.shape
    d = d4 // 4
    pad = -b % ROWS
    xf = torch.cat([xs.float(), torch.zeros(t_steps, pad, d4)], 1)
    mask = torch.cat([mask, torch.zeros(t_steps, pad)], 1)
    h = torch.cat([h0.float(), torch.zeros(pad, d)])
    c = torch.cat([c0, torch.zeros(pad, d)])
    wf, bf = w.float(), bias.float().reshape(d4)
    units = d // n_ctas
    hs, cs, acts = [], [], []
    for t in range(t_steps):
        gates = torch.empty(b + pad, d4)
        for rank in range(n_ctas):
            j = torch.arange(rank * units, (rank + 1) * units)
            cols = torch.cat([q * d + j for q in range(4)])
            p = []
            for g in range(4):
                s = torch.zeros(b + pad, cols.numel())
                for k in range(g, d, 4):
                    s = _fma_chain(s, h[:, k:k + 1], wf[k, cols][None, :])
                p.append(s)
            gates[:, cols] = (xf[t][:, cols] +
                              ((p[0] + p[2]) + (p[1] + p[3]))) + bf[cols]
        gc, gi, gf, go = gates.split(d, dim=1)
        ig, fg, og = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        cand = torch.tanh(gc)
        c_new = fg * c + ig * cand
        h_new = og * torch.tanh(c_new)
        m = mask[t][:, None]
        h = (m * h_new + (1 - m) * h).to(h0.dtype).float()
        c = m * c_new + (1 - m) * c
        hs.append(h[:b].to(h0.dtype))
        cs.append(c[:b])
        acts.append(torch.cat([cand, ig, fg, og], dim=1)[:b].to(w.dtype))
    return torch.stack(hs), torch.stack(cs), torch.stack(acts)


@pytest.mark.parametrize('n_ctas', [1, 2, 4])
def test_fwd_cluster_emulation_matches_plain(n_ctas):
    """The forward as a cluster of ``n_ctas`` CTAs computes it agrees with
    lstm_fwd_plain (ragged rows: a length-0 row, a full row, a batch of 10
    that leaves the last cluster half empty) within chip_smoke.py's f32
    tolerance for hs, cs and acts, and is bitwise the same at every cluster
    size: each sum over k runs in the same order whichever rank owns the
    unit."""
    b, t, d = 10, 12, 32
    xs, w, bias, h0, c0, mask, _, _ = _torch(*_inputs(b, t, d, seed=9))
    args = (xs, w, bias, h0, c0, mask)
    got = _emulate_fwd_cluster(*args, n_ctas)
    want = lk.lstm_fwd_plain(*args)
    for name, g, wnt in zip(('hs', 'cs', 'acts'), got, want):
        assert g.shape == wnt.shape and g.dtype == wnt.dtype, name
        tol = CHIP_TOL * max(1.0, wnt.abs().max().item())
        assert (g - wnt).abs().max().item() <= tol, name
    assert torch.equal(got[0][:, 0], h0[0].expand(t, d))  # the length-0 row
    if n_ctas > 1:
        for g, one in zip(got, _emulate_fwd_cluster(*args, 1)):
            assert torch.equal(g, one)
