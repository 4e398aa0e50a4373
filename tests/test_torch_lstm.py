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
                                  'h0_shape'])
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
    with pytest.raises(ValueError):
        lk._launch_fwd(xs, w, bias, h0, c0, mask, True)


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
