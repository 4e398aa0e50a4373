"""The PyTorch port's sequence slice held against the JAX package on the CPU:
LoD feeds padded the same way, each lowering the slice adds in one-op
programs (``sequence_pool`` of every type, ``cross_entropy``, ``top_k`` and
``accuracy``, ``fc`` over two inputs, ``lstm`` on its scan path and on its
kernel path, with gradients), the stacked-LSTM model's programs, and the
model in both forms (as built, with peepholes: the scan path; without
peepholes under ``FLAGS_fused_lstm='always'``: the kernels' plain version
here and the Pallas kernels in interpret mode there) served and trained
three Adam steps from the same state.

Tolerances: one-op outputs 1e-5 (the same f32 arithmetic up to summation
order); gradients within 1e-4 of their own max|g| (the recurrence's products
and the dW sums over every step run in another order).  The model: the
prediction and losses rtol 1e-5; each gradient within 1e-4 of its own
max|g|; persistable vars within 1e-4, a tenth of one Adam step at lr 0.002
and below it, since Adam divides by sqrt(m2) + eps and so turns a rounding
difference in a small gradient into a larger one in the update.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as jexecutor
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.fluid import shape_policy as jshape_policy
from paddle_tpu.models import stacked_lstm as jax_stacked_lstm

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid import shape_policy as tshape_policy
from paddle_tpu_torch.models import stacked_lstm as torch_stacked_lstm
from paddle_tpu_torch.ops import sequence_ops

import chip_smoke

TOL = 1e-5
GRAD_TOL = 1e-4
SMALL = dict(dict_dim=100, emb_dim=32, hid_dim=128, stacked_num=3,
             class_dim=2)


def _lod(fluid, rows, lengths):
    return fluid.create_lod_tensor(rows, [list(lengths)])


def test_bucketed_len_is_the_jax_ladder():
    for n in range(0, 1500):
        assert tshape_policy.bucketed_len(n) == jshape_policy.bucketed_len(n)
    assert tshape_policy.SEQ_BUCKET == jshape_policy.SEQ_BUCKET


@pytest.mark.parametrize('lengths', [(3, 0, 5), (16, 1), (17, 2), (300, 4)])
@pytest.mark.parametrize('dtype', ['int64', 'float32'])
def test_lod_feed_pads_like_jax(lengths, dtype):
    rng = np.random.RandomState(len(lengths))
    rows = (rng.standard_normal((sum(lengths), 3)) * 10).astype(dtype)
    want = jexecutor.prepare_feed_arrays({'x': _lod(jfluid, rows, lengths)})
    got = texecutor.prepare_feed_arrays({'x': _lod(tfluid, rows, lengths)})
    assert sorted(got) == sorted(want) == ['x', 'x@SEQLEN']
    for name in want:
        w, g = np.asarray(want[name]), got[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got['x'].shape[1] == tshape_policy.bucketed_len(max(lengths))


def test_nested_lod_feed_waits_for_a_later_slice():
    t = tfluid.create_lod_tensor(np.zeros((5, 1), 'int64'), [[2, 1], [2, 2, 1]])
    with pytest.raises(NotImplementedError, match='later sequence slice'):
        texecutor.prepare_feed_arrays({'x': t})


def _run(fluid, build, feed, fetch, startup_from=None, grads=()):
    """Build ``build(fluid)`` in fresh programs, run its startup (or take the
    persistables of ``startup_from``, the JAX scope), run it on the CPU and
    fetch ``fetch`` and the gradients of the vars named in ``grads``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = build(fluid)
        if grads:
            fluid.backward.append_backward(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    if startup_from is None:
        exe.run(startup, scope=scope)
    else:
        names = [v.name for v in main.list_vars() if v.persistable]
        fluid.persistables_from_numpy(
            main, {n: np.asarray(startup_from.find_var(n).value())
                   for n in names}, scope=scope, place=fluid.CPUPlace())
    out = exe.run(main, feed=feed(fluid), scope=scope,
                  fetch_list=list(fetch) + [g + '@GRAD' for g in grads])
    return [np.asarray(o) for o in out], scope


def _both(build, feed, fetch, grads=()):
    want, jscope = _run(jfluid, build, feed, fetch, grads=grads)
    got, _ = _run(tfluid, build, feed, fetch, startup_from=jscope,
                  grads=grads)
    n = len(fetch)
    for name, w, g in zip(fetch, want[:n], got[:n]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    for name, w, g in zip(grads, want[n:], got[n:]):
        assert g.shape == w.shape and np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name + '@GRAD')


_SEQ_LENGTHS = (3, 0, 5, 1)
_SEQ_ROWS = np.random.RandomState(7).standard_normal(
    (sum(_SEQ_LENGTHS), 6)).astype('float32')


@pytest.mark.parametrize('pool', ['sum', 'average', 'sqrt', 'max', 'last',
                                  'first', 'first_step', 'last_step'])
def test_sequence_pool_matches_jax(pool):
    """Every pool type over rows of lengths 3, 0, 5 and 1; a length-0 row
    pools to 0 under max."""
    def build(fluid):
        x = fluid.layers.data(name='x', shape=[6], dtype='float32',
                              lod_level=1)
        if pool.endswith('_step'):
            fn = getattr(fluid.layers, 'sequence_' + pool)
            return fn(x)
        return fluid.layers.sequence_pool(x, pool_type=pool)

    feed = lambda fluid: {'x': _lod(fluid, _SEQ_ROWS, _SEQ_LENGTHS)}
    _both(build, feed, ['sequence_pool_0.tmp_0'])
    out, _ = _run(tfluid, build, feed, ['sequence_pool_0.tmp_0'])
    if pool == 'max':
        assert np.all(out[0][1] == 0)


@pytest.mark.parametrize('soft', [False, True])
def test_cross_entropy_matches_jax(soft):
    rng = np.random.RandomState(3)
    logits = rng.standard_normal((6, 5))
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
        'float32')
    if soft:
        label = rng.dirichlet(np.ones(5), size=6).astype('float32')
    else:
        label = rng.randint(0, 5, size=(6, 1)).astype('int64')
        label[2, 0] = -100  # ignored: loss 0

    def build(fluid):
        p = fluid.layers.data(name='p', shape=[5], dtype='float32')
        lbl = fluid.layers.data(name='lbl', shape=[5 if soft else 1],
                                dtype='float32' if soft else 'int64')
        return fluid.layers.cross_entropy(p, lbl, soft_label=soft)

    _both(build, lambda fluid: {'p': probs, 'lbl': label},
          ['cross_entropy_0.tmp_0'])


def test_top_k_and_accuracy_match_jax():
    rng = np.random.RandomState(5)
    probs = rng.uniform(size=(9, 6)).astype('float32')
    label = rng.randint(0, 6, size=(9, 1)).astype('int64')

    def build(fluid):
        p = fluid.layers.data(name='p', shape=[6], dtype='float32')
        lbl = fluid.layers.data(name='lbl', shape=[1], dtype='int64')
        return fluid.layers.accuracy(p, lbl, k=2)

    # top_k's values and indices, then accuracy, correct and total
    _both(build, lambda fluid: {'p': probs, 'lbl': label},
          ['accuracy_0.tmp_%d' % i for i in range(5)])


def test_fc_over_two_inputs_matches_jax():
    rng = np.random.RandomState(6)
    a = rng.standard_normal((4, 3)).astype('float32')
    b = rng.standard_normal((4, 5)).astype('float32')

    def build(fluid):
        xa = fluid.layers.data(name='a', shape=[3], dtype='float32')
        xb = fluid.layers.data(name='b', shape=[5], dtype='float32')
        out = fluid.layers.fc(input=[xa, xb], size=2, act='relu')
        return fluid.layers.mean(out)

    _both(build, lambda fluid: {'a': a, 'b': b},
          ['fc_0.tmp_2', 'fc_0.tmp_4'], grads=['fc_0.w_0', 'fc_0.w_1',
                                               'fc_0.b_0'])


_LSTM_LENGTHS = (7, 4, 12, 3, 0, 9, 1, 5)  # B = 8 (the JAX kernel's rule)
_LSTM_ROWS = np.random.RandomState(8).standard_normal(
    (sum(_LSTM_LENGTHS), 16)).astype('float32')


def _lstm_net(use_peepholes, is_reverse):
    def build(fluid):
        x = fluid.layers.data(name='x', shape=[16], dtype='float32',
                              lod_level=1)
        proj = fluid.layers.fc(input=x, size=512)
        h, c = fluid.layers.dynamic_lstm(input=proj, size=512,
                                         use_peepholes=use_peepholes,
                                         is_reverse=is_reverse)
        return fluid.layers.mean(h)

    return build


@pytest.mark.parametrize('is_reverse', [False, True])
@pytest.mark.parametrize('path', ['scan_peepholes', 'scan', 'kernel'])
def test_lstm_matches_jax(path, is_reverse):
    """The lstm op on its scan path (with and without peepholes, 'auto' on
    the CPU in both packages) and on its kernel path ('always' in both: the
    plain version here, the Pallas kernels in interpret mode there), forward
    and gradients."""
    mode = 'always' if path == 'kernel' else 'auto'
    old = jflags.FLAGS.fused_lstm, tfluid.FLAGS.fused_lstm
    jflags.FLAGS.fused_lstm = tfluid.FLAGS.fused_lstm = mode
    try:
        _both(_lstm_net(path == 'scan_peepholes', is_reverse),
              lambda fluid: {'x': _lod(fluid, _LSTM_ROWS, _LSTM_LENGTHS)},
              ['lstm_0.tmp_0', 'lstm_0.tmp_1'],
              grads=['lstm_0.w_0', 'lstm_0.b_0', 'fc_0.w_0'])
    finally:
        jflags.FLAGS.fused_lstm, tfluid.FLAGS.fused_lstm = old


@pytest.mark.parametrize('mode,device,peepholes,want', [
    ('auto', 'cuda', False, True), ('always', 'cuda', False, True),
    ('never', 'cuda', False, False), ('auto', 'cpu', False, False),
    ('always', 'cpu', False, True), ('never', 'cpu', False, False),
    ('always', 'cuda', True, False), ('auto', 'cuda', True, False)])
def test_fused_lstm_policy(mode, device, peepholes, want):
    old = tfluid.FLAGS.fused_lstm
    tfluid.FLAGS.fused_lstm = mode
    try:
        ok = sequence_ops._fused_lstm_ok(
            torch.device(device), 128, 128, torch.float32, peepholes,
            'sigmoid', 'tanh', 'tanh')
        # a width the kernels do not take is ineligible in every mode
        odd = sequence_ops._fused_lstm_ok(
            torch.device(device), 100, 128, torch.float32, peepholes,
            'sigmoid', 'tanh', 'tanh')
    finally:
        tfluid.FLAGS.fused_lstm = old
    assert ok == want and not odd


def _desc(program):
    ops = [(op.type, {k: list(v) for k, v in op.inputs.items()},
            {k: list(v) for k, v in op.outputs.items()},
            sorted((k, repr(v)) for k, v in op.attrs.items()))
           for op in program.global_block().ops]
    var_list = sorted((v.name, tuple(v.shape), v.dtype, v.lod_level,
                       v.persistable) for v in program.list_vars())
    return ops, var_list


def test_stacked_lstm_builds_the_jax_programs():
    with jfluid.unique_name.guard():
        jm = jax_stacked_lstm.build()
    with tfluid.unique_name.guard():
        tm = torch_stacked_lstm.build()
    for key in ('main', 'test', 'startup'):
        assert _desc(tm[key]) == _desc(jm[key]), key
    assert len(tm['test'].global_block().ops) == 25
    params = {p.name: tuple(p.shape) for p in tm['main'].all_parameters()}
    assert params['lstm_0.b_0'] == (1, 896)  # 7D: peepholes on
    assert sum(np.prod(s) for s in params.values()) == 1582082
    # chip_smoke.stacked_lstm_programs builds the same net: as built with
    # peepholes, and the kernels' form differs only in the LSTMs' bias
    # width and attrs
    with tfluid.unique_name.guard():
        same = chip_smoke.stacked_lstm_programs(tfluid, use_peepholes=True)
    for key in ('main', 'test', 'startup'):
        assert _desc(same[key]) == _desc(tm[key]), key
    with tfluid.unique_name.guard():
        bare = chip_smoke.stacked_lstm_programs(tfluid, use_peepholes=False)
    assert [op.type for op in bare['main'].global_block().ops] == \
        [op.type for op in tm['main'].global_block().ops]
    assert {p.name: tuple(p.shape) for p in bare['main'].all_parameters()
            }['lstm_2.b_0'] == (1, 512)


def _model(fluid, form):
    if form == 'as built':
        pkg = jax_stacked_lstm if fluid is jfluid else torch_stacked_lstm
        return pkg.build(**SMALL)
    return chip_smoke.stacked_lstm_programs(fluid, use_peepholes=False,
                                            **SMALL)


def _feed(fluid, rng_seed):
    rng = np.random.RandomState(rng_seed)
    lengths = rng.randint(1, 13, size=8)
    ids = rng.randint(0, SMALL['dict_dim'], size=(lengths.sum(), 1))
    label = rng.randint(0, 2, size=(8, 1)).astype('int64')
    return {'words': fluid.create_lod_tensor(ids.astype('int64'),
                                             [lengths.tolist()]),
            'label': label}


@pytest.mark.parametrize('form', ['as built', 'kernel'])
def test_stacked_lstm_serves_and_trains_like_jax(form):
    mode = 'always' if form == 'kernel' else 'auto'
    old = jflags.FLAGS.fused_lstm, tfluid.FLAGS.fused_lstm
    jflags.FLAGS.fused_lstm = tfluid.FLAGS.fused_lstm = mode
    try:
        with jfluid.unique_name.guard():
            jm = _model(jfluid, form)
        with tfluid.unique_name.guard():
            tm = _model(tfluid, form)
        jscope = jfluid.Scope()
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jm['startup'], scope=jscope)
        state = [v.name for v in jm['main'].list_vars() if v.persistable]
        tscope = tfluid.Scope()
        tfluid.persistables_from_numpy(
            tm['main'], {n: np.asarray(jscope.find_var(n).value())
                         for n in state}, scope=tscope,
            place=tfluid.CPUPlace())
        texe = tfluid.Executor(tfluid.CPUPlace())

        serve = [jm['prediction'].name, jm['acc'].name]
        want = jexe.run(jm['test'], feed=_feed(jfluid, 1), fetch_list=serve,
                        scope=jscope)
        got = texe.run(tm['test'], feed=_feed(tfluid, 1), fetch_list=serve,
                       scope=tscope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))

        params = [p.name for p in tm['main'].all_parameters()]
        fetch = [tm['loss'].name] + [p + '@GRAD' for p in params]
        for step in range(3):
            want = jexe.run(jm['main'], feed=_feed(jfluid, 10 + step),
                            fetch_list=fetch, scope=jscope)
            got = texe.run(tm['main'], feed=_feed(tfluid, 10 + step),
                           fetch_list=fetch, scope=tscope)
            np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=TOL)
            if step == 0:
                for name, w, g in zip(params, want[1:], got[1:]):
                    w = np.asarray(w)
                    assert np.abs(g).max() > 0, name
                    np.testing.assert_allclose(
                        g, w, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                        err_msg=name)
            for name in state:
                np.testing.assert_allclose(
                    tscope.find_var(name).value().numpy(),
                    np.asarray(jscope.find_var(name).value()), rtol=1e-4,
                    atol=1e-4, err_msg='%s after step %d' % (name, step + 1))
    finally:
        jflags.FLAGS.fused_lstm, tfluid.FLAGS.fused_lstm = old
