"""The PyTorch port's common tensor, shape, reduce, loss and metric lowerings
held against the JAX package on the CPU, one-op program against one-op
program, on the same seeded numpy inputs: the shape ops (``reshape2``,
``transpose``/``transpose2``, ``squeeze``/``squeeze2``, ``unsqueeze2``,
``flatten``/``flatten2``, ``split``, ``shape``, ``slice``, ``stack``,
``unstack``), the index, sort and fill ops (``reverse``, ``pad``,
``pad2d``, ``multiplex``, ``label_smooth``, ``argmax``/``argmin`` and their
``arg_*`` names, ``argsort``, ``crop``, ``scatter``, ``isfinite``), the
math ops (``reduce_mean``/``max``/``min``/``prod``, ``elementwise_mod`` and
``elementwise_floordiv``, ``squared_l2_norm``, ``squared_l2_distance``,
``cumsum``, ``l1_norm``, ``norm``), the eight losses and the three metrics.
Each differentiable op's generic grad (``torch.func.vjp``) is held against
``jax.vjp`` of the JAX lowering.  The random ops
(``truncated_gaussian_random``, the ``*_batch_size_like`` pair and
``random_crop``) are held by distribution: the torch and JAX streams
differ.

Tolerance: f32 outputs and gradients at rtol 1e-5 / atol 1e-6 (the
gradients' atol scaled by max(1, max|g|)); integer and bool outputs
exactly, by value (the JAX package's int64 outputs come out int32).  The
random ops: every draw in its support, and the mean and standard deviation
of 10^5 draws within 0.02 of the JAX package's (each statistic's standard
error is under 0.007).
"""

import os
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.ops import registry as jregistry

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import registry as tregistry

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from chip_smoke import (one_op_program, one_op_grad_program,  # noqa: E402
                        op_out_names)

RTOL, ATOL = 1e-5, 1e-6


def _run(fluid, prog, feed, fetch, extra=None):
    feed = dict(feed, **(extra or {}))
    return [np.asarray(o) for o in fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch, scope=fluid.Scope())]


def _forward(fluid, case, extra=None):
    prog, feed = one_op_program(fluid, *case[:4])
    return _run(fluid, prog, feed, op_out_names(case[2]), extra)


def _grads(fluid, case, out, wrt, cot, extra=None):
    """The gradients of the vars ``wrt`` with the cotangent ``cot`` fed to
    the output var ``out``."""
    prog, feed, names = one_op_grad_program(fluid, case, out, wrt, cot)
    return _run(fluid, prog, feed, names, extra)


def _same(name, got, want):
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind in 'biu':
        # values, not dtypes: the JAX package's int64 comes out int32
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def _check(case, out=None, wrt=(), extra=None):
    """The forward outputs, then (with ``out``) the gradients of ``wrt``,
    of the port against the JAX package.  ``extra``: feeds beside the
    op's inputs (the sample mask)."""
    want = _forward(jfluid, case, extra)
    got = _forward(tfluid, case, extra)
    for name, w, g in zip(op_out_names(case[2]), want, got):
        _same(name, g, w)
    if out is None:
        return
    shape = want[op_out_names(case[2]).index(out)].shape
    cot = np.random.RandomState(8).standard_normal(shape).astype('float32')
    want = _grads(jfluid, case, out, wrt, cot, extra)
    got = _grads(tfluid, case, out, wrt, cot, extra)
    for name, w, g in zip(wrt, want, got):
        assert g.shape == w.shape, name
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=name + '@GRAD')


# ---- the ported lowerings ----

NEW_LOWERINGS = sorted(chip_smoke.OPS_LOWERINGS)
# the one-op cases path K2 of chip_smoke.py runs on the card
CASES = chip_smoke.ops_cases()


def test_the_slice_registers_52_lowerings_of_the_reference():
    assert len(NEW_LOWERINGS) == 52
    for name in NEW_LOWERINGS:
        assert name in jregistry._LOWERINGS, name
        assert name in tregistry._LOWERINGS, name
    assert tregistry._LOWERINGS['arg_max'] is tregistry._LOWERINGS['argmax']
    assert tregistry._LOWERINGS['arg_min'] is tregistry._LOWERINGS['argmin']


@pytest.mark.parametrize('name', sorted(CASES))
def test_lowering_and_generic_grad_like_jax(name):
    case = CASES[name]
    _check(case[:4], out=case[4], wrt=case[5])


def test_every_new_deterministic_lowering_has_a_case():
    covered = {case[0] for case in CASES.values()}
    assert covered | set(chip_smoke.OPS_RANDOM) == set(NEW_LOWERINGS)


def test_xshape_outputs_hold_the_input_shape_behind_a_zero_dim():
    for name in ('reshape2', 'transpose2', 'squeeze2', 'unsqueeze2',
                 'flatten2'):
        case = CASES[name]
        got = _forward(tfluid, case[:4])
        xs = got[op_out_names(case[2]).index('xs')]
        assert xs.shape == (0, ) + case[1]['X'][1].shape, name
        assert xs.dtype == np.float32, name


def test_reduce_mean_and_sum_leave_a_padded_lots_padding_rows_out():
    """Under the ragged-batch mask (1 a real row, 0 padding) reduce_mean
    and reduce_sum over the batch dim skip the padding rows, in the
    forward and in the generic grad; reduce_max is not masked."""
    x = chip_smoke.op_rand(80, 5, 3, 4)
    x[3:] = 100.0  # padding rows: they would dominate every statistic
    mask = {tregistry.SAMPLE_MASK_NAME:
            np.array([1, 1, 1, 0, 0], 'float32')}
    cases = [
        ('reduce_mean', {'dim': [0], 'keep_dim': False,
                         'reduce_all': False}),
        ('reduce_mean', {'dim': [0, 2], 'keep_dim': True,
                         'reduce_all': False}),
        ('reduce_mean', {'dim': [0], 'keep_dim': False,
                         'reduce_all': True}),
        ('reduce_sum', {'dim': [0], 'keep_dim': False, 'reduce_all': True}),
        ('reduce_max', {'dim': [0], 'keep_dim': False,
                        'reduce_all': False}),
    ]
    for op_type, attrs in cases:
        case = (op_type, {'X': ('x', x)}, {'Out': 'out'}, attrs)
        _check(case, out='out', wrt=['x'], extra=mask)
    # the padding rows' gradient of a masked mean is 0
    got = _grads(tfluid, ('reduce_mean', {'X': ('x', x)}, {'Out': 'out'},
                          cases[0][1]), 'out', ['x'],
                 np.ones((3, 4), 'float32'), mask)[0]
    assert not got[3:].any() and got[:3].all()
    mean = _forward(tfluid, ('reduce_mean', {'X': ('x', x)},
                             {'Out': 'out'}, cases[2][1]), mask)[0]
    np.testing.assert_allclose(mean, [x[:3].mean()], rtol=RTOL)


def test_a_flattened_batch_under_the_mask_warns_like_jax():
    """A [B*T, ..] value of batch ancestry reaching reduce_mean cannot be
    masked: both packages warn."""
    def build(fluid):
        prog = fluid.Program()
        with fluid.program_guard(prog, fluid.Program()):
            x = fluid.layers.data(name='x', shape=[3, 4], dtype='float32')
            flat = fluid.layers.reshape(x, [-1, 4])
            fluid.layers.reduce_mean(flat)
        return prog
    feed = {'x': chip_smoke.op_rand(81, 4, 3, 4),
            tregistry.SAMPLE_MASK_NAME: np.array([1, 1, 1, 0], 'float32')}
    for fluid in (jfluid, tfluid):
        prog = build(fluid)
        out = prog.global_block().ops[-1].output('Out')[0]
        with pytest.warns(UserWarning, match='(?i)flattened batch'):
            fluid.Executor(fluid.CPUPlace()).run(
                prog, feed=feed, fetch_list=[out], scope=fluid.Scope())


# ---- the random ops, by distribution ----

def _draw(fluid, op_type, inputs, attrs, seed=0):
    """One run of a one-op program with ``program.random_seed`` set."""
    case = (op_type, inputs, {'Out': 'out'}, attrs)
    prog, feed = one_op_program(fluid, *case)
    prog.random_seed = seed
    return _run(fluid, prog, feed, ['out'])[0]


def _same_distribution(got, want, lo, hi):
    assert got.shape == want.shape
    assert got.min() >= lo and got.max() <= hi
    assert want.min() >= lo and want.max() <= hi
    assert abs(got.mean() - want.mean()) < 0.02
    assert abs(got.std() - want.std()) < 0.02


def test_truncated_gaussian_random_by_distribution():
    attrs = {'shape': [1000, 100], 'mean': 0.5, 'std': 1.0, 'dtype': 5}
    got = _draw(tfluid, 'truncated_gaussian_random', {}, attrs, seed=3)
    want = _draw(jfluid, 'truncated_gaussian_random', {}, attrs, seed=3)
    _same_distribution(got, want, -1.5, 2.5)
    # a standard normal cut at +-2 has standard deviation 0.8796
    assert abs(got.std() - 0.8796) < 0.01
    # a nonzero seed attr: its own generator, the same draws each run
    seeded = dict(attrs, seed=11)
    np.testing.assert_array_equal(
        _draw(tfluid, 'truncated_gaussian_random', {}, seeded, seed=1),
        _draw(tfluid, 'truncated_gaussian_random', {}, seeded, seed=2))


@pytest.mark.parametrize('op_type', ['uniform_random_batch_size_like',
                                     'gaussian_random_batch_size_like'])
def test_batch_size_like_randoms_by_distribution(op_type):
    ref = ('ref', chip_smoke.op_rand(90, 1000, 3))
    attrs = {'shape': [1, 100], 'input_dim_idx': 0, 'output_dim_idx': 0,
             'dtype': 5, 'seed': 0}
    if op_type.startswith('uniform'):
        attrs.update(min=-2.0, max=1.0)
        lo, hi = -2.0, 1.0
    else:
        attrs.update(mean=1.0, std=0.5)
        lo, hi = -np.inf, np.inf
    got = _draw(tfluid, op_type, {'Input': ref}, attrs, seed=4)
    want = _draw(jfluid, op_type, {'Input': ref}, attrs, seed=4)
    assert got.shape == (1000, 100)
    _same_distribution(got, want, lo, hi)


def test_random_crop_takes_a_window_at_uniform_starts():
    """Each run's output is X's window at some start in each trailing dim;
    over 60 runs the starts cover the range as the JAX package's do."""
    x = np.arange(2 * 6 * 7, dtype='float32').reshape(2, 6, 7)
    starts = {}
    for fluid in (tfluid, jfluid):
        prog, feed = one_op_program(fluid, 'random_crop', {'X': ('x', x)},
                              {'Out': 'out'}, {'shape': [3, 4]})
        prog.random_seed = 5
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        seen = set()
        for _ in range(60):
            out = np.asarray(exe.run(prog, feed=feed, fetch_list=['out'],
                                     scope=scope)[0])
            assert out.shape == (2, 3, 4)
            r, c = int(out[0, 0, 0]) // 7, int(out[0, 0, 0]) % 7
            np.testing.assert_array_equal(out, x[:, r:r + 3, c:c + 4])
            seen.add((r, c))
        starts[fluid] = seen
    for seen in starts.values():
        assert {r for r, _ in seen} == set(range(4))
        assert {c for _, c in seen} == set(range(4))
