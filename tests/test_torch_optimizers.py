"""The PyTorch port's optimizers and learning-rate schedules held against the
JAX package on the CPU: the nine optimizer ops the port took on
(``adagrad``, ``decayed_adagrad``, ``adadelta``, ``adamax``, ``rmsprop``,
``ftrl``, ``proximal_gd``, ``proximal_adagrad``, ``average_accumulates``)
one-op against the JAX lowerings; each optimizer's ``minimize`` program
(op list, accumulators and their initializers) equal to the JAX
package's; three steps of the MNIST MLP (784-200-200-10, batch 8) with
each, every persistable var handed over from the JAX scope before each
step; each schedule's rate over 10 runs against the JAX package's and its
closed form; ``append_LARS``; a schedule driving SGD; the proximal and
``ModelAverage`` cases of ``tests/test_misc_ops.py`` and
``tests/test_op_tail.py``; the six sparse optimizers (row subset: Adagrad,
RMSProp, Ftrl, Adadelta; ``lazy_apply``: Adamax, DecayedAdagrad) against
the JAX package's with untouched rows bitwise unchanged; and the
Transformer (n_layer=2) three Adam steps under ``2 * noam_decay``.

Tolerances (the same f32 arithmetic up to summation order):
- one-op outputs and schedule rates: 1e-5 relative and absolute; the
  closed forms (f64) 1e-6 relative;
- MLP steps: the loss 1e-5 relative; each gradient |dg| / |g| 1e-4; each
  update (after - before) and each accumulator |d| / |v| 1e-4; under Adam
  and Adamax, whose first steps move an element by lr g / (|g| + eps)
  whatever the scale of its gradient (rounding noise either way), no
  element by more than 2 lr and, over the elements whose |g| is at least
  1e-3 of the parameter's largest, the root mean square difference 1e-4
  of lr (``test_torch_cv_ops.ModelParity``'s rule), each difference taken
  beyond one ulp of the parameter (the rounding of p + dp, not small beside
  the Transformer's first steps of lr 1e-6 under noam's warmup);
- sparse steps: 1e-5 relative and absolute (``merge_rows`` sums in f64,
  the JAX package scatter-adds in f32); untouched rows bitwise;
- the Transformer: the loss 1e-5 relative, gradients 1e-4, the Adam rule
  above for the parameters, the moments 1e-4.
"""

import math
import os
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.models import transformer as torch_transformer
from paddle_tpu_torch.ops import registry as tregistry

from test_torch_cv_ops import _forward, _norm_rel
from test_torch_control_flow import _build, _desc, _same, hand_over

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TOL = 1e-5
STEP_TOL = 1e-4
NEW_OPS = ('adagrad', 'decayed_adagrad', 'adadelta', 'adamax', 'rmsprop',
           'ftrl', 'proximal_gd', 'proximal_adagrad', 'average_accumulates')


def test_the_optimizer_ops_are_registered_and_sparsified():
    for op in NEW_OPS:
        assert op in tregistry._LOWERINGS, op
    from paddle_tpu.ops import registry as jregistry
    for op in ('sgd', 'momentum', 'adam', 'adamax', 'adagrad',
               'decayed_adagrad', 'rmsprop', 'adadelta', 'ftrl'):
        # the sparsifying wrapper, in both packages
        assert tregistry._LOWERINGS[op].__name__ == 'wrapped', op
        assert jregistry._LOWERINGS[op].__name__ == 'wrapped', op


# ---- the optimizer ops, one-op ----

def _op_cases():
    rng = np.random.RandomState(3)
    f32 = lambda *s: rng.standard_normal(s).astype('float32')
    pos = lambda *s: np.abs(f32(*s)) + 0.1
    lr = ('lr', np.array([0.05], 'float32'))
    p, g = ('p', f32(3, 4)), ('g', f32(3, 4))
    cases = {
        'adagrad': ('adagrad', {'Param': p, 'Grad': g, 'Moment': (
            'm', pos(3, 4)), 'LearningRate': lr},
            {'ParamOut': 'po', 'MomentOut': 'mo'}, {'epsilon': 1e-6}),
        'decayed_adagrad': ('decayed_adagrad', {
            'Param': p, 'Grad': g, 'Moment': ('m', pos(3, 4)),
            'LearningRate': lr}, {'ParamOut': 'po', 'MomentOut': 'mo'},
            {'epsilon': 1e-6, 'decay': 0.9}),
        'adadelta': ('adadelta', {
            'Param': p, 'Grad': g, 'AvgSquaredGrad': ('a', pos(3, 4)),
            'AvgSquaredUpdate': ('u', pos(3, 4))},
            {'ParamOut': 'po', 'AvgSquaredGradOut': 'ao',
             'AvgSquaredUpdateOut': 'uo'}, {'epsilon': 1e-6, 'rho': 0.9}),
        'adamax': ('adamax', {
            'Param': p, 'Grad': g, 'Moment': ('m', f32(3, 4)),
            'InfNorm': ('n', pos(3, 4)), 'Beta1Pow': (
                'b1p', np.array([0.81], 'float32')), 'LearningRate': lr},
            {'ParamOut': 'po', 'MomentOut': 'mo', 'InfNormOut': 'no'},
            {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}),
        'proximal_gd': ('proximal_gd', {'Param': p, 'Grad': g,
                                        'LearningRate': lr},
                        {'ParamOut': 'po'}, {'l1': 0.05, 'l2': 0.02}),
        'proximal_adagrad': ('proximal_adagrad', {
            'Param': p, 'Grad': g, 'Moment': ('m', pos(3, 4)),
            'LearningRate': lr}, {'ParamOut': 'po', 'MomentOut': 'mo'},
            {'l1': 0.05, 'l2': 0.02}),
        'proximal_adagrad_zero_grad': ('proximal_adagrad', {
            'Param': ('p', np.ones((2, 2), 'float32')),
            'Grad': ('g', np.zeros((2, 2), 'float32')),
            'Moment': ('m', np.zeros((2, 2), 'float32')),
            'LearningRate': ('lr', np.array([0.1], 'float32'))},
            {'ParamOut': 'po', 'MomentOut': 'mo'}, {'l1': 0.01, 'l2': 0.0}),
    }
    for momentum in (0.0, 0.9):
        cases['rmsprop_%g' % momentum] = ('rmsprop', {
            'Param': p, 'Grad': g, 'MeanSquare': ('ms', pos(3, 4)),
            'Moment': ('m', f32(3, 4)), 'LearningRate': lr},
            {'ParamOut': 'po', 'MomentOut': 'mo', 'MeanSquareOut': 'mso'},
            {'epsilon': 1e-6, 'decay': 0.95, 'momentum': momentum})
    sq = pos(3, 4)
    sq[0] = 0.0  # a zero accumulator
    for l1, l2, power in ((0.0, 0.0, -0.5), (0.1, 0.2, -0.5),
                          (0.1, 0.0, -0.25)):
        cases['ftrl_%g_%g_%g' % (l1, l2, power)] = ('ftrl', {
            'Param': p, 'Grad': g, 'SquaredAccumulator': ('sq', sq),
            'LinearAccumulator': ('lin', f32(3, 4)), 'LearningRate': lr},
            {'ParamOut': 'po', 'SquaredAccumOut': 'sqo',
             'LinearAccumOut': 'lino'},
            {'l1': l1, 'l2': l2, 'lr_power': power})
    # average_accumulates: a step inside the window, one that closes it,
    # and one that rolls sum_1 into sum_2 (num_updates % 16384 == 0)
    for name, (n_acc, n_upd, rate, lo) in {
            'open': (3, 5, 10.0, 100), 'close': (9, 9, 1.0, 2),
            'roll': (2, 16383, 10.0, 100)}.items():
        cases['average_accumulates_' + name] = ('average_accumulates', {
            'param': p, 'in_sum_1': ('s1', f32(3, 4)),
            'in_sum_2': ('s2', f32(3, 4)), 'in_sum_3': ('s3', f32(3, 4)),
            'in_num_accumulates': ('na', np.array([n_acc], 'int64')),
            'in_old_num_accumulates': ('ona', np.array([4], 'int64')),
            'in_num_updates': ('nu', np.array([n_upd], 'int64'))},
            {'out_sum_1': 'o1', 'out_sum_2': 'o2', 'out_sum_3': 'o3',
             'out_num_accumulates': 'ona_', 'out_old_num_accumulates':
             'oona', 'out_num_updates': 'onu'},
            {'average_window': rate, 'min_average_window': lo,
             'max_average_window': 1000})
    return cases


OP_CASES = _op_cases()


@pytest.mark.parametrize('name', sorted(OP_CASES))
def test_optimizer_op_matches_jax(name):
    case = OP_CASES[name]
    want = _forward(jfluid, case)
    got = _forward(tfluid, case)
    for slot, g, w in zip(case[2], got, want):
        assert np.isfinite(g).all(), (name, slot)
        _same(g, w, '%s %s' % (name, slot))


def test_proximal_ops_match_numpy():
    """tests/test_misc_ops.py's proximal cases against their numpy
    forms."""
    case = OP_CASES['proximal_gd']
    (p, g, lr), (l1, l2) = ((case[1][s][1] for s in ('Param', 'Grad',
                                                     'LearningRate')),
                            (0.05, 0.02))
    prox = p - lr * g
    want = np.sign(prox) * np.maximum(np.abs(prox) - lr * l1, 0) / (
        1 + lr * l2)
    np.testing.assert_allclose(_forward(tfluid, case)[0], want, rtol=TOL,
                               atol=TOL)
    case = OP_CASES['proximal_adagrad']
    m = case[1]['Moment'][1]
    m_out = m + g * g
    eff = lr / np.sqrt(m_out)
    prox = p - eff * g
    want = np.sign(prox) * np.maximum(np.abs(prox) - eff * l1, 0) / (
        1 + eff * l2)
    po, mo = _forward(tfluid, case)
    np.testing.assert_allclose(po, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(mo, m_out, rtol=TOL)
    po, mo = _forward(tfluid, OP_CASES['proximal_adagrad_zero_grad'])
    np.testing.assert_array_equal(po, np.ones((2, 2)))  # no NaN, no move
    assert not mo.any()


# ---- the optimizers on the MNIST MLP ----

OPTIMIZERS = {
    'adagrad': lambda fluid: fluid.optimizer.Adagrad(0.05),
    'adamax': lambda fluid: fluid.optimizer.Adamax(0.01),
    'decayed_adagrad': lambda fluid: fluid.optimizer.DecayedAdagrad(0.05),
    'adadelta': lambda fluid: fluid.optimizer.Adadelta(1.0, rho=0.9),
    'rmsprop': lambda fluid: fluid.optimizer.RMSProp(0.01),
    'rmsprop_momentum': lambda fluid: fluid.optimizer.RMSProp(
        0.01, momentum=0.9),
    'ftrl': lambda fluid: fluid.optimizer.Ftrl(0.1, l1=1e-4, l2=1e-4),
    'proximal_gd': lambda fluid: fluid.optimizer.ProximalGD(0.1, l1=1e-4),
    'proximal_adagrad': lambda fluid: fluid.optimizer.ProximalAdagrad(
        0.1, l1=1e-4, l2=1e-4),
}
# whose first steps move each element by about lr whatever its gradient
SIGN_LIKE = ('adamax', )


def mlp_programs(fluid, optimizer, lr=None):
    """The MNIST MLP (784-200-200-10, tanh, softmax), trained by
    ``optimizer(fluid)`` (or ``optimizer(fluid, lr)`` with a schedule)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data('img', shape=[784])
        label = fluid.layers.data('label', shape=[1], dtype='int64')
        h = fluid.layers.fc(img, size=200, act='tanh')
        h = fluid.layers.fc(h, size=200, act='tanh')
        pred = fluid.layers.fc(h, size=10, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        opt = optimizer(fluid) if lr is None else optimizer(fluid, lr(fluid))
        opt.minimize(loss)
    return dict(main=main, startup=startup, loss=loss, opt=opt,
                fetch=[loss.name])


def _mnist_feed(rng, batch=8):
    return {'img': rng.uniform(-1, 1, (batch, 784)).astype('float32'),
            'label': rng.randint(0, 10, (batch, 1)).astype('int64')}


def _step_parity(jm, tm, jexe, texe, jscope, tscope, feed, sign_like, lr,
                 fetch_extra=()):
    """One step on each side from the JAX scope's state: the loss, each
    gradient, each update and accumulator, as the docstring says.
    Returns (loss, extra fetches)."""
    before = hand_over(tm, jscope, tscope)
    params = [p.name for p in tm['main'].all_parameters()]
    fetch = [tm['loss'].name] + [p + '@GRAD' for p in params] + \
        list(fetch_extra)
    want = jexe.run(jm['main'], feed=feed, fetch_list=fetch, scope=jscope)
    got = texe.run(tm['main'], feed=feed, fetch_list=fetch, scope=tscope)
    w_loss = float(np.asarray(want[0])[0])
    assert abs(float(got[0][0]) - w_loss) <= TOL * abs(w_loss)
    grads = {}
    for name, g, w in zip(params, got[1:], want[1:]):
        grads[name] = np.asarray(w)
        assert _norm_rel(g, w) <= STEP_TOL, name + '@GRAD'
    for v in tm['main'].list_vars():
        if not v.persistable:
            continue
        g = tscope.find_var(v.name).value().numpy()
        w = np.asarray(jscope.find_var(v.name).value())
        if g.dtype.kind != 'f':
            np.testing.assert_array_equal(g, w.astype(g.dtype), v.name)
        elif v.name in grads and sign_like:
            # beyond the rounding of the updated parameter itself (one ulp
            # of it), which is not small beside a step of lr 1e-6
            d = np.maximum(np.abs(g - w) - np.spacing(np.abs(w)), 0)
            assert d.max() <= 2 * lr * (1 + 1e-3), v.name
            gw = np.abs(grads[v.name])
            d = d[gw >= 1e-3 * gw.max()].astype(np.float64)
            assert np.sqrt(np.mean(np.square(d))) / lr <= STEP_TOL, v.name
        elif v.name in grads:
            assert _norm_rel(g - before[v.name], w - before[v.name]) <= \
                STEP_TOL, v.name
        elif np.abs(w).max() > 0:
            assert _norm_rel(g, w) <= STEP_TOL, v.name
    return float(got[0][0]), got[len(params) + 1:]


def _pair(build):
    jm, tm = _build(build)
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(jm['startup'], scope=jscope)
    return jm, tm, jexe, texe, jscope, tscope


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_mlp_trains_three_steps_like_jax(name):
    """The program (op list, accumulators: ``_build`` compares every var)
    and three steps, each from the JAX package's state."""
    jm, tm, jexe, texe, jscope, tscope = _pair(
        lambda fluid: mlp_programs(fluid, OPTIMIZERS[name]))
    types = [op.type for op in tm['main'].global_block().ops]
    assert types.count(tm['opt'].type) == 6  # one per parameter
    rng = np.random.RandomState(5)
    lr = getattr(tm['opt'], '_learning_rate', 1.0)
    losses = [_step_parity(jm, tm, jexe, texe, jscope, tscope,
                           _mnist_feed(rng), name in SIGN_LIKE, lr)[0]
              for _ in range(3)]
    assert np.isfinite(losses).all()


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_accumulators_are_named_as_in_jax(name):
    """Each accumulator's name, shape, dtype and initial value."""
    jm, tm = _build(lambda fluid: mlp_programs(fluid, OPTIMIZERS[name]))
    accs = {n: v for n, v in tm['opt']._accumulators.items()}
    assert sorted(accs) == sorted(jm['opt']._accumulators)
    for acc, by_param in accs.items():
        assert sorted(v.name for v in by_param.values()) == sorted(
            v.name for v in jm['opt']._accumulators[acc].values())
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(tm['startup'], scope=scope)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jm['startup'], scope=jscope)
    for by_param in accs.values():
        for v in by_param.values():
            _same(scope.find_var(v.name).value().numpy(),
                  np.asarray(jscope.find_var(v.name).value()), v.name)


def test_proximal_optimizers_train():
    """tests/test_misc_ops.py::test_proximal_optimizers_train: 30 steps of
    a linear fit halve the loss, in both packages alike."""
    rng = np.random.RandomState(7)
    xv = rng.standard_normal((16, 4)).astype(np.float32)
    yv = (xv @ np.asarray([1., -2., 0.5, 3.], np.float32)[:, None])
    for make in (lambda fluid: fluid.optimizer.ProximalGD(
            learning_rate=0.1, l1=1e-4), lambda fluid:
            fluid.optimizer.ProximalAdagrad(learning_rate=0.5, l1=1e-4)):
        def build(fluid):
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                x = fluid.layers.data(name='x', shape=[4], dtype='float32')
                y = fluid.layers.data(name='y', shape=[1], dtype='float32')
                loss = fluid.layers.mean(fluid.layers.square_error_cost(
                    fluid.layers.fc(x, size=1), y))
                make(fluid).minimize(loss)
            return dict(main=main, startup=startup, fetch=[loss.name])

        jm, tm, jexe, texe, jscope, tscope = _pair(build)
        hand_over(tm, jscope, tscope)
        losses = []
        for _ in range(30):
            feed = {'x': xv, 'y': yv}
            w, = jexe.run(jm['main'], feed=feed, fetch_list=jm['fetch'],
                          scope=jscope)
            g, = texe.run(tm['main'], feed=feed, fetch_list=tm['fetch'],
                          scope=tscope)
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4)
            losses.append(float(g[0]))
        assert losses[-1] < losses[0] * 0.5


# ---- ModelAverage ----

def _model_average_programs(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        pred = fluid.layers.fc(x, size=1, bias_attr=False)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
        # the window never closes within 6 steps (rate 10): the average
        # is the mean of every updated parameter
        ma = fluid.optimizer.ModelAverage(
            average_window_rate=10.0, min_average_window=1,
            max_average_window=100)
    return dict(main=main, startup=startup, fetch=[loss.name], ma=ma,
                apply=ma.apply_program, restore=ma.restore_program)


def test_model_average_like_jax():
    """tests/test_op_tail.py::test_model_average in both packages: the
    applied parameters are the mean of the six updated ones, and
    ``restore`` puts back the pre-apply parameters bit for bit."""
    jm, tm = _build(_model_average_programs)
    for key in ('apply', 'restore'):
        assert _desc(tm[key]) == _desc(jm[key]), key
    rng = np.random.RandomState(8)
    xv = rng.standard_normal((8, 4)).astype(np.float32)
    yv = xv.sum(1, keepdims=True).astype(np.float32)
    results, start = [], None
    for fluid, m in ((jfluid, jm), (tfluid, tm)):
        param = m['main'].global_block().all_parameters()[0].name
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        value = lambda: np.array(scope.find_var(param).value(), copy=True)
        with fluid.scope_guard(scope):
            exe.run(m['startup'])
            if start is None:  # the JAX package's initial state
                start = {v.name: np.array(scope.find_var(v.name).value(),
                                          v.np_dtype)
                         for v in m['main'].list_vars() if v.persistable}
            else:
                tfluid.persistables_from_numpy(m['main'], start, scope=scope,
                                               place=tfluid.CPUPlace())
            snapshots = []
            for _ in range(6):
                exe.run(m['main'], feed={'x': xv, 'y': yv},
                        fetch_list=m['fetch'])
                snapshots.append(value())
            with m['ma'].apply(exe):
                averaged = value()
            restored = value()
        np.testing.assert_allclose(averaged, np.mean(snapshots, axis=0),
                                   rtol=1e-5)
        np.testing.assert_array_equal(restored, snapshots[-1])
        results.append((np.stack(snapshots), averaged))
    for g, w in zip(results[1], results[0]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


# ---- learning-rate schedules ----

SCHEDULES = {
    'noam': (lambda fluid: fluid.layers.noam_decay(64, 4),
             lambda s: 64 ** -0.5 * min((s + 1) ** -0.5,
                                        (s + 1) * 4 ** -1.5)),
    'noam_scaled': (lambda fluid: 2.0 * fluid.layers.noam_decay(512, 3),
                    lambda s: chip_smoke.noam_lr(s + 1, 512, 2.0, 3)),
    'exponential': (lambda fluid: fluid.layers.exponential_decay(
        0.1, 3, 0.5), lambda s: 0.1 * 0.5 ** (s / 3)),
    'exponential_staircase': (lambda fluid: fluid.layers.exponential_decay(
        1.0, 10, 0.5, staircase=True), lambda s: 0.5 ** (s // 10)),
    'natural_exp': (lambda fluid: fluid.layers.natural_exp_decay(
        0.1, 3, 0.5), lambda s: 0.1 * math.exp(-0.5 * s / 3)),
    'inverse_time': (lambda fluid: fluid.layers.inverse_time_decay(
        0.1, 3, 0.5), lambda s: 0.1 / (1 + 0.5 * s / 3)),
    'polynomial': (lambda fluid: fluid.layers.polynomial_decay(
        0.1, 5, end_learning_rate=0.01, power=2.0),
        lambda s: 0.09 * (1 - min(s, 5) / 5) ** 2 + 0.01),
    'polynomial_cycle': (lambda fluid: fluid.layers.polynomial_decay(
        0.1, 3, cycle=True), lambda s: 0.0999 * (
            1 - s / (3 * max(math.ceil(s / 3), 1))) + 1e-4),
    'piecewise': (lambda fluid: fluid.layers.piecewise_decay(
        [3, 6], [1.0, 0.5, 0.1]), lambda s: 1.0 if s < 3 else
        0.5 if s < 6 else 0.1),
}


def _schedule_program(make):
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            lr = make(fluid)
        return dict(main=main, startup=startup, fetch=[lr.name])
    return build


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_matches_jax_and_its_closed_form(name):
    make, closed = SCHEDULES[name]
    jm, tm = _build(_schedule_program(make))
    rates = []
    for fluid, m in ((jfluid, jm), (tfluid, tm)):
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(m['startup'], scope=scope)
        rates.append([float(np.asarray(exe.run(
            m['main'], fetch_list=m['fetch'], scope=scope)[0])[0])
            for _ in range(10)])
    np.testing.assert_allclose(rates[1], rates[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rates[1], [closed(s) for s in range(10)],
                               rtol=1e-6)


def test_schedule_values_of_test_aux():
    """tests/test_aux.py's values: exponential staircase 1.0 for steps
    0-9 then 0.5; piecewise [3, 6] -> 1, 0.5, 0.1."""
    for name, want in (('exponential_staircase', [1.0] * 10 + [0.5] * 2),
                       ('piecewise', [1.0] * 3 + [0.5] * 3 + [0.1] * 2)):
        _, tm = _build(_schedule_program(SCHEDULES[name][0]))
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(tm['startup'], scope=scope)
        got = [float(exe.run(tm['main'], fetch_list=tm['fetch'],
                             scope=scope)[0][0]) for _ in want]
        np.testing.assert_allclose(got, want, rtol=TOL)


def test_optimizer_with_lr_scheduler_trains_like_jax():
    """tests/test_aux.py::test_optimizer_with_lr_scheduler_trains: SGD under
    exponential_decay, 10 steps on new batches, in parity."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data('x', [4])
            y = fluid.layers.data('y', [1])
            loss = fluid.layers.mean(fluid.layers.square_error_cost(
                fluid.layers.fc(x, 1), y))
            lr = fluid.layers.exponential_decay(0.1, decay_steps=5,
                                                decay_rate=0.9)
            fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
        return dict(main=main, startup=startup, fetch=[loss.name, lr.name])

    jm, tm, jexe, texe, jscope, tscope = _pair(build)
    hand_over(tm, jscope, tscope)
    rng = np.random.RandomState(0)
    losses = []
    for step in range(10):
        xb = rng.randn(16, 4).astype('float32')
        feed = {'x': xb, 'y': (xb.sum(1, keepdims=True) * 0.5).astype(
            'float32')}
        want = jexe.run(jm['main'], feed=feed, fetch_list=jm['fetch'],
                        scope=jscope)
        got = texe.run(tm['main'], feed=feed, fetch_list=tm['fetch'],
                       scope=tscope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4)
        np.testing.assert_allclose(got[1], 0.1 * 0.9 ** (step / 5),
                                   rtol=1e-6)
        losses.append(float(got[0][0]))
    assert losses[-1] < losses[0]


def test_append_lars_like_jax():
    """``append_LARS`` sets each parameter's rate to a Variable (through
    math_op_patch's overloads); SGD ops driven by those rates, three steps
    in parity, each rate against its closed form."""
    lr, wd = 0.1, 0.0005

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data('x', [4])
            y = fluid.layers.data('y', [1])
            loss = fluid.layers.mean(fluid.layers.square_error_cost(
                fluid.layers.fc(fluid.layers.fc(x, 8, act='tanh'), 1), y))
            params_grads = fluid.backward.append_backward(loss)
            fluid.layers.append_LARS(params_grads, lr, wd)
            rates = []
            for p, g in params_grads:
                rate = p.optimize_attr['learning_rate']
                rates.append(rate.name)
                main.global_block().append_op(
                    type='sgd', inputs={'Param': [p], 'Grad': [g],
                                        'LearningRate': [rate]},
                    outputs={'ParamOut': [p]})
        return dict(main=main, startup=startup,
                    fetch=[loss.name] + rates + [p.name + '@GRAD' for p, _
                                                 in params_grads],
                    params=[p.name for p, _ in params_grads])

    jm, tm, jexe, texe, jscope, tscope = _pair(build)
    rng = np.random.RandomState(2)
    for _ in range(3):
        before = hand_over(tm, jscope, tscope)
        xb = rng.randn(16, 4).astype('float32')
        feed = {'x': xb, 'y': xb[:, :1]}
        want = jexe.run(jm['main'], feed=feed, fetch_list=jm['fetch'],
                        scope=jscope)
        got = texe.run(tm['main'], feed=feed, fetch_list=tm['fetch'],
                       scope=tscope)
        n = len(tm['params'])
        for name, g, w in zip(tm['fetch'], got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-7, err_msg=name)
        for name, rate, grad in zip(tm['params'], got[1:1 + n],
                                    got[1 + n:]):
            pn = np.linalg.norm(before[name].astype(np.float64))
            gn = np.linalg.norm(grad.astype(np.float64))
            np.testing.assert_allclose(rate, lr * pn / (gn + wd * pn),
                                       rtol=1e-5)


# ---- the sparse optimizers ----

SPARSE = {
    'adagrad': lambda fluid: fluid.optimizer.Adagrad(0.1),
    'rmsprop': lambda fluid: fluid.optimizer.RMSProp(0.01, momentum=0.5),
    'ftrl': lambda fluid: fluid.optimizer.Ftrl(0.1, l1=1e-3, l2=1e-3),
    'adadelta': lambda fluid: fluid.optimizer.Adadelta(1.0, rho=0.9),
    'adamax': lambda fluid: fluid.optimizer.Adamax(0.05),
    'decayed_adagrad': lambda fluid: fluid.optimizer.DecayedAdagrad(0.1),
}
VOCAB, DIM = 50, 4


def _embedding_programs(optimizer):
    """One sparse lookup of a [50, 4] table, loss = mean(sum(x^2))."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ids = fluid.layers.data(name='ids', shape=[3], dtype='int64')
            emb = fluid.layers.embedding(
                ids, size=[VOCAB, DIM], is_sparse=True,
                param_attr=fluid.ParamAttr(name='emb_w'))
            flat = fluid.layers.reshape(emb, shape=[0, -1])
            loss = fluid.layers.mean(fluid.layers.reduce_sum(
                fluid.layers.elementwise_mul(flat, flat), dim=-1))
            optimizer(fluid).minimize(loss)
        return dict(main=main, startup=startup, fetch=[loss.name],
                    loss=loss)
    return build


@pytest.mark.parametrize('name', sorted(SPARSE))
def test_sparse_optimizer_step_matches_jax_and_is_lazy(name):
    """Step 1 touches ids 0-11 (a repeated hot id 2); step 2, from the
    JAX package's state, touches 1, 3, 5 only: every persistable var
    against the JAX package's after each step, and after step 2 the
    untouched rows of the table and of every accumulator bitwise as they
    were, with no NaN anywhere (Ftrl's zero accumulators included)."""
    jm, tm, jexe, texe, jscope, tscope = _pair(
        _embedding_programs(SPARSE[name]))
    rng = np.random.RandomState(1)
    first = {'ids': rng.randint(0, 12, (8, 3)).astype('int64')}
    first['ids'][:, 0] = 2
    second = {'ids': np.array([[1, 3, 3], [5, 1, 3]], 'int64')}
    state = [v.name for v in tm['main'].list_vars() if v.persistable]
    for feed in (first, second):
        before = hand_over(tm, jscope, tscope)
        want, = jexe.run(jm['main'], feed=feed, fetch_list=jm['fetch'],
                         scope=jscope)
        got, = texe.run(tm['main'], feed=feed, fetch_list=tm['fetch'],
                        scope=tscope)
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL)
        for n in state:
            value = tscope.find_var(n).value().numpy()
            assert np.isfinite(value).all(), n
            _same(value, np.asarray(jscope.find_var(n).value()), n)
    touched = np.zeros(VOCAB, bool)
    touched[[1, 3, 5]] = True
    rows = [n for n in state if tscope.find_var(n).value().shape[0] == VOCAB]
    assert len(rows) >= 2  # the table and its accumulators
    for n in rows:
        value = tscope.find_var(n).value().numpy()
        np.testing.assert_array_equal(value[~touched], before[n][~touched],
                                      n)
    table = tscope.find_var('emb_w').value().numpy()
    assert (table[touched] != before['emb_w'][touched]).all()


# ---- the Transformer under noam_decay ----

SMALL = dict(src_vocab=64, trg_vocab=64, max_len=16, n_layer=2, n_head=4,
             d_model=32, d_ff=64)
WARMUP = 4000  # the recipe's (the schedule tests cross noam's two branches)


def test_transformer_noam_three_steps_like_jax():
    """Fluid's Transformer recipe at n_layer=2: Adam (beta2 0.98, epsilon
    1e-9) under 2 * noam_decay(d_model, WARMUP); three steps, each from the
    JAX package's state, with the rate fetched against noam's closed form
    at steps 1-3."""
    def build(fluid):
        m = chip_smoke.transformer_noam_programs(
            fluid, jax_transformer if fluid is jfluid else torch_transformer,
            warmup_steps=WARMUP, **SMALL)
        m['fetch'] = [m['loss'].name]
        return m

    jm, tm, jexe, texe, jscope, tscope = _pair(build)
    ops = [op.type for op in tm['main'].global_block().ops]
    assert ops.count('adam') == len(tm['main'].all_parameters())
    rng = np.random.RandomState(0)
    for step in range(1, 4):
        feed = {n: rng.randint(1, 64, (2, 16)).astype('int64')
                for n in tm['feeds']}
        lr = chip_smoke.noam_lr(step, SMALL['d_model'], warmup_steps=WARMUP)
        _, (rate, ) = _step_parity(jm, tm, jexe, texe, jscope, tscope, feed,
                                   True, lr, fetch_extra=[tm['lr'].name])
        np.testing.assert_allclose(rate, lr, rtol=1e-6)
