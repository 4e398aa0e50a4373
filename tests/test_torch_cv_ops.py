"""The PyTorch port's dense CV lowerings held against the JAX package on the
CPU, one-op program against one-op program: every activation lowering (and
the unary ``pow``), ``conv2d`` and ``depthwise_conv2d``, ``pool2d``,
``batch_norm`` in each of its modes on 4-D and 2-D inputs, ``sgd`` and
``momentum``; each differentiable one's generic grad (``torch.func.vjp``)
against the JAX package's (``jax.vjp``); the layers ``conv2d`` (its
depthwise form), ``batch_norm`` (train, ``clone(for_test)``, each
``use_global_stats``) and the conv filter's random init by distribution.

Tolerance: 1e-5, relative and absolute, for every output and gradient (the
same f32 arithmetic up to summation order; the gradients are scaled by
max(1, max|g|), as a conv's filter gradient sums thousands of products).
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.ops import registry as jregistry

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import registry as tregistry

TOL = 1e-5


def _program(fluid, op_type, inputs, outputs, attrs):
    """A program holding one op: ``inputs`` {slot: (name, array)},
    ``outputs`` {slot: name}; returns (program, feed)."""
    prog = fluid.Program()
    blk = prog.global_block()
    feed = {}
    for name, arr in inputs.values():
        blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
        feed[name] = arr
    for name in outputs.values():
        if not blk.has_var(name):
            blk.create_var(name=name, dtype='float32')
    blk.append_op(type=op_type,
                  inputs={s: [n] for s, (n, _) in inputs.items()},
                  outputs={s: [n] for s, n in outputs.items()},
                  attrs=attrs)
    return prog, feed


def _forward(fluid, case):
    op_type, inputs, outputs, attrs = case[:4]
    prog, feed = _program(fluid, op_type, inputs, outputs, attrs)
    out = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=list(outputs.values()),
        scope=fluid.Scope())
    return [np.asarray(o) for o in out]


def _grads(fluid, case, slot, wrt, cot):
    """The gradients of the vars ``wrt`` of ``case``'s op, with the
    cotangent ``cot`` fed to its output ``slot``."""
    op_type, inputs, outputs, attrs = case[:4]
    prog, feed = _program(fluid, op_type, inputs, outputs, attrs)
    with fluid.program_guard(prog, fluid.Program()):
        blk = prog.global_block()
        cvar = blk.create_var(name='cot', shape=cot.shape, dtype='float32')
        feed['cot'] = cot
        fluid.backward.calc_gradient(targets=[blk.var(outputs[slot])],
                                     inputs=[blk.var(n) for n in wrt],
                                     target_gradients=[cvar])
    out = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=[n + '@GRAD' for n in wrt],
        scope=fluid.Scope())
    return [np.asarray(o) for o in out]


def _check(case, slot=None, wrt=(), nonzero=True):
    """Forward outputs, then (with ``slot``) the gradients of ``wrt``, of
    the port against the JAX package."""
    want = _forward(jfluid, case)
    got = _forward(tfluid, case)
    for name, w, g in zip(case[2].values(), want, got):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    if slot is None:
        return
    shape = want[list(case[2]).index(slot)].shape
    cot = np.random.RandomState(8).standard_normal(shape).astype('float32')
    want = _grads(jfluid, case, slot, wrt, cot)
    got = _grads(tfluid, case, slot, wrt, cot)
    for name, w, g in zip(wrt, want, got):
        assert g.shape == w.shape, name
        if nonzero:
            assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name + '@GRAD')


# ---- activations ----

def _activation_lowerings():
    """Every lowering of the JAX package's activation_ops module."""
    return sorted(name for name, fn in jregistry._LOWERINGS.items()
                  if fn.__module__ == 'paddle_tpu.ops.activation_ops')


ACTIVATIONS = _activation_lowerings() + ['pow']
_POSITIVE = {'log', 'sqrt', 'reciprocal', 'pow'}
_STEP = {'ceil', 'floor', 'round'}  # zero gradient everywhere


def test_every_activation_lowering_is_ported():
    assert len(ACTIVATIONS) == 33
    missing = [n for n in ACTIVATIONS if n not in tregistry._LOWERINGS]
    assert not missing
    for op in ('conv2d', 'depthwise_conv2d', 'pool2d', 'batch_norm', 'sgd',
               'momentum'):
        assert op in tregistry._LOWERINGS


def _activation_case(name, mode='all'):
    rng = np.random.RandomState(sum(map(ord, name)))
    x = (rng.standard_normal((2, 4, 3, 3)) * 4).astype('float32')
    if name in _POSITIVE:
        x = np.abs(x) + 0.5
    inputs = {'X': ('x', x)}
    attrs = {}
    if name == 'maxout':
        attrs = {'groups': 2}
    elif name == 'pow':
        attrs = {'factor': 2.5}
    elif name == 'prelu':
        shape = {'all': (1, ), 'channel': (4, ), 'element': (4, 3, 3)}[mode]
        inputs['Alpha'] = ('alpha', rng.uniform(0.1, 0.5, shape).astype(
            'float32'))
        attrs = {'mode': mode}
    return name, inputs, {'Out': 'out'}, attrs


@pytest.mark.parametrize('name', ACTIVATIONS)
def test_activation_matches_jax(name):
    """Forward at the reference's default attrs, then the generic grad."""
    case = _activation_case(name)
    _check(case, 'Out', [n for n, _ in case[1].values()],
           nonzero=name not in _STEP)


@pytest.mark.parametrize('mode', ['all', 'channel', 'element'])
def test_prelu_modes_match_jax(mode):
    case = _activation_case('prelu', mode)
    _check(case, 'Out', ['x', 'alpha'])


# ---- conv2d ----

_CONV = {
    'plain': (6, 1, (3, 3), dict()),
    'stride_pad': (6, 1, (3, 3), dict(strides=[2, 2], paddings=[1, 1])),
    'dilation': (6, 1, (3, 3), dict(paddings=[2, 2], dilations=[2, 2])),
    'groups': (6, 2, (3, 3), dict(paddings=[1, 1])),
    'rect': (5, 1, (3, 2), dict(strides=[1, 2], paddings=[0, 1])),
    'depthwise': (4, 4, (3, 3), dict(strides=[2, 2], paddings=[1, 1])),
}


@pytest.mark.parametrize('name', sorted(_CONV))
def test_conv2d_matches_jax(name):
    filters, groups, k, attrs = _CONV[name]
    rng = np.random.RandomState(len(name))
    x = rng.standard_normal((2, 4, 7, 7)).astype('float32')
    w = rng.standard_normal((filters, 4 // groups) + k).astype('float32')
    attrs = dict(dict(strides=[1, 1], paddings=[0, 0], dilations=[1, 1],
                      groups=groups, use_cudnn=False), **attrs)
    op_type = 'depthwise_conv2d' if name == 'depthwise' else 'conv2d'
    case = (op_type, {'Input': ('x', x), 'Filter': ('w', w)},
            {'Output': 'y'}, attrs)
    _check(case, 'Output', ['x', 'w'])


def test_conv2d_layer_emits_depthwise_like_jax():
    """groups == C == num_filters > 1 builds depthwise_conv2d in both
    packages, and the port runs it."""
    x = np.random.RandomState(3).standard_normal((2, 4, 6, 6)).astype(
        'float32')

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data(name='img', shape=[4, 6, 6],
                                    dtype='float32')
            y = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                    groups=4, padding=1, act='relu')
        return main, startup, y

    jmain, jstart, jy = build(jfluid)
    tmain, _, ty = build(tfluid)
    types = [op.type for op in tmain.global_block().ops]
    assert types == [op.type for op in jmain.global_block().ops]
    assert types[0] == 'depthwise_conv2d'
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    want, = jexe.run(jmain, feed={'img': x}, fetch_list=[jy], scope=jscope)
    tscope = tfluid.Scope()
    tfluid.persistables_from_numpy(
        tmain, {p.name: np.asarray(jscope.find_var(p.name).value())
                for p in tmain.all_parameters()}, scope=tscope,
        place=tfluid.CPUPlace())
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={'img': x}, fetch_list=[ty], scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_conv2d_filter_init_by_distribution():
    """The filter's Normal(0, sqrt(2 / (k^2 C))) draw cannot match the
    JAX package's bit for bit: its mean and std are held to the law instead
    (4 standard errors for the mean, 2% for the std over 36864 draws)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name='img', shape=[64, 8, 8],
                                 dtype='float32')
        tfluid.layers.conv2d(img, num_filters=64, filter_size=3,
                             bias_attr=False)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    w = scope.find_var('conv2d_0.w_0').value().numpy()
    std = (2.0 / (9 * 64))**0.5
    assert w.shape == (64, 64, 3, 3)
    assert abs(w.mean()) < 4 * std / np.sqrt(w.size)
    assert abs(w.std() / std - 1) < 0.02


# ---- pool2d ----

_POOL = {
    'max_k2s2': ('max', 7, dict(ksize=[2, 2], strides=[2, 2])),
    'max_resnet_stem': ('max', 7, dict(ksize=[3, 3], strides=[2, 2],
                                       paddings=[1, 1])),
    'avg_pad_exclusive': ('avg', 7, dict(ksize=[3, 3], strides=[2, 2],
                                         paddings=[1, 1])),
    'avg_pad_inclusive': ('avg', 7, dict(ksize=[3, 3], strides=[2, 2],
                                         paddings=[1, 1], exclusive=False)),
    'max_ceil': ('max', 6, dict(ksize=[3, 3], strides=[2, 2],
                                ceil_mode=True)),
    'avg_ceil_inclusive': ('avg', 6, dict(ksize=[3, 3], strides=[2, 2],
                                          ceil_mode=True, exclusive=False)),
    'avg_ceil_pad': ('avg', 6, dict(ksize=[3, 3], strides=[2, 2],
                                    paddings=[1, 1], ceil_mode=True)),
    # the last window lies wholly in the padding: -inf in both packages
    'max_ceil_window_in_padding': ('max', 5, dict(ksize=[2, 2],
                                                  strides=[2, 2],
                                                  paddings=[1, 1],
                                                  ceil_mode=True)),
    'avg_wide_pad': ('avg', 6, dict(ksize=[3, 3], strides=[2, 2],
                                    paddings=[2, 2])),
    'max_wide_pad': ('max', 6, dict(ksize=[2, 2], strides=[2, 2],
                                    paddings=[2, 2])),
    'avg_rect': ('avg', 7, dict(ksize=[2, 3], strides=[1, 2],
                                paddings=[1, 0])),
    'avg_global': ('avg', 7, dict(ksize=[2, 2], strides=[2, 2],
                                  paddings=[1, 1], global_pooling=True)),
    'max_global': ('max', 7, dict(ksize=[2, 2], global_pooling=True)),
}


@pytest.mark.parametrize('name', sorted(_POOL))
def test_pool2d_matches_jax(name):
    ptype, size, attrs = _POOL[name]
    x = np.random.RandomState(len(name)).standard_normal(
        (2, 3, size, size)).astype('float32')
    attrs = dict(dict(pooling_type=ptype, strides=[1, 1], paddings=[0, 0],
                      global_pooling=False, ceil_mode=False,
                      exclusive=True), **attrs)
    case = ('pool2d', {'X': ('x', x)}, {'Out': 'out'}, attrs)
    if name == 'max_ceil_window_in_padding':
        assert np.isneginf(_forward(tfluid, case)[0][:, :, -1, -1]).all()
    _check(case, 'Out', ['x'])


# ---- batch_norm ----

_BN_MODES = {
    'train': dict(is_test=False),
    'is_test': dict(is_test=True),
    'train_global_stats': dict(is_test=False, use_global_stats=True),
    'test_batch_stats': dict(is_test=True, use_global_stats=False),
    'test_global_stats': dict(is_test=True, use_global_stats=True),
    'train_batch_stats': dict(is_test=False, use_global_stats=False),
}


def _bn_case(mode, rank, in_place=False):
    rng = np.random.RandomState(rank)
    c = 5
    shape = (4, c, 3, 3) if rank == 4 else (6, c)
    # a channel mean of 1 against a std of 2: E[x^2] - E[x]^2 cancels a little
    x = (rng.standard_normal(shape) * 2 + 1).astype('float32')
    inputs = {'X': ('x', x),
              'Scale': ('scale', rng.standard_normal(c).astype('float32')),
              'Bias': ('bias', rng.standard_normal(c).astype('float32')),
              'Mean': ('mean', rng.standard_normal(c).astype('float32')),
              'Variance': ('var', rng.uniform(0.5, 2, c).astype('float32'))}
    outputs = {'Y': 'y', 'MeanOut': 'mean' if in_place else 'mean_out',
               'VarianceOut': 'var' if in_place else 'var_out',
               'SavedMean': 'saved_mean', 'SavedVariance': 'saved_var'}
    attrs = dict(momentum=0.9, epsilon=1e-5, data_layout='NCHW',
                 **_BN_MODES[mode])
    return ('batch_norm', inputs, outputs, attrs)


@pytest.mark.parametrize('rank', [4, 2])
@pytest.mark.parametrize('mode', sorted(_BN_MODES))
def test_batch_norm_matches_jax(mode, rank):
    """Y, MeanOut, VarianceOut, SavedMean and SavedVariance, then the
    gradients of X, Scale and Bias (and of Mean and Variance where the
    running statistics normalize)."""
    case = _bn_case(mode, rank)
    running = mode in ('is_test', 'train_global_stats', 'test_global_stats')
    wrt = ['x', 'scale', 'bias'] + (['mean', 'var'] if running else [])
    _check(case, 'Y', wrt)
    y, mean_out, var_out, saved_mean, saved_var = _forward(tfluid, case)
    mean_in, var_in = case[1]['Mean'][1], case[1]['Variance'][1]
    if mode in ('train', 'train_batch_stats'):
        axes = (0, 2, 3) if rank == 4 else (0, )
        x = case[1]['X'][1].astype('float64')
        np.testing.assert_allclose(saved_var, x.var(axis=axes), rtol=1e-5)
        np.testing.assert_allclose(
            mean_out, 0.9 * mean_in + 0.1 * x.mean(axis=axes), rtol=1e-5)
    else:  # the running statistics do not move
        np.testing.assert_array_equal(mean_out, mean_in)
        np.testing.assert_array_equal(var_out, var_in)


@pytest.mark.parametrize('rank', [4, 2])
def test_batch_norm_grad_after_running_stats_are_overwritten(rank):
    """MeanOut and VarianceOut name the Mean and Variance vars, as the layer
    builds them: the generic grad replays batch_norm after the forward has
    overwritten Mean, which Y does not read in training."""
    _check(_bn_case('train', rank, in_place=True), 'Y',
           ['x', 'scale', 'bias'])


@pytest.mark.parametrize('program', ['main', 'test'])
@pytest.mark.parametrize('use_global_stats', [None, True, False])
def test_batch_norm_layer_matches_jax(use_global_stats, program):
    """The layer in a training program and in its clone(for_test): Y and
    the running statistics left in the scope; an eval pass does not move
    them, whatever ``use_global_stats`` says."""
    x = (np.random.RandomState(5).standard_normal((4, 3, 5, 5)) * 3 +
         2).astype('float32')

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data(name='img', shape=[3, 5, 5],
                                    dtype='float32')
            y = fluid.layers.batch_norm(img, act='relu',
                                        use_global_stats=use_global_stats)
            loss = fluid.layers.mean(y)
            test = main.clone(for_test=True)
            fluid.backward.append_backward(loss)
        return {'main': main, 'test': test}[program], startup, y

    jprog, jstart, jy = build(jfluid)
    tprog, _, ty = build(tfluid)
    bn = [op for op in tprog.global_block().ops if op.type == 'batch_norm']
    assert bn[0].attrs['is_test'] == (program == 'test')
    assert ('use_global_stats' in bn[0].attrs) == (use_global_stats
                                                   is not None)
    stats = ['batch_norm_0.w_1', 'batch_norm_0.w_2']
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name).value())
             for v in tprog.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    tfluid.persistables_from_numpy(tprog, state, scope=tscope,
                                   place=tfluid.CPUPlace())
    want, = jexe.run(jprog, feed={'img': x}, fetch_list=[jy], scope=jscope)
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tprog, feed={'img': x}, fetch_list=[ty], scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    for name in stats:
        after = tscope.find_var(name).value().numpy()
        np.testing.assert_allclose(
            after, np.asarray(jscope.find_var(name).value()), rtol=TOL,
            atol=TOL, err_msg=name)
        moved = not np.array_equal(after, state[name])
        assert moved == (program == 'main' and not use_global_stats), name


# ---- optimizers ----

@pytest.mark.parametrize('name', ['sgd', 'momentum', 'momentum_nesterov'])
def test_optimizer_op_matches_jax(name):
    rng = np.random.RandomState(9)
    f32 = lambda *s: rng.standard_normal(s).astype('float32')
    inputs = {'Param': ('p', f32(3, 4)), 'Grad': ('g', f32(3, 4)),
              'LearningRate': ('lr', np.array([0.05], 'float32'))}
    outputs = {'ParamOut': 'p_out'}
    attrs = {}
    if name != 'sgd':
        inputs['Velocity'] = ('v', f32(3, 4))
        outputs['VelocityOut'] = 'v_out'
        attrs = {'mu': 0.9, 'use_nesterov': name.endswith('nesterov')}
    case = (name.split('_')[0], inputs, outputs, attrs)
    _check(case)
    p, g, lr = (inputs[s][1] for s in ('Param', 'Grad', 'LearningRate'))
    got = _forward(tfluid, case)
    if name == 'sgd':
        want = [p - lr * g]
    else:
        v = 0.9 * inputs['Velocity'][1] + g
        step = g + 0.9 * v if attrs['use_nesterov'] else v
        want = [p - lr * step, v]
    for w, o in zip(want, got):
        np.testing.assert_allclose(o, w, rtol=TOL, atol=TOL)


# ---- model parity, shared by test_torch_mnist, test_torch_resnet and
# test_torch_vgg ----

def _attr_desc(value):
    """An attr comparable across the packages: a block (``sub_block``) by
    its index, anything else by its repr."""
    if hasattr(value, 'ops') and hasattr(value, 'parent_idx'):
        return 'block %d' % value.idx
    return repr(value)


def program_desc(program):
    """A program's blocks, each with its index, its parent, its ops (type,
    slots, attrs) and its vars (name, shape, dtype, lod level,
    persistable), comparable across the two packages."""
    return [(blk.idx, blk.parent_idx,
             [(op.type, {k: list(v) for k, v in op.inputs.items()},
               {k: list(v) for k, v in op.outputs.items()},
               sorted((k, _attr_desc(v)) for k, v in op.attrs.items()))
              for op in blk.ops],
             sorted((v.name, tuple(v.shape), v.dtype, v.lod_level,
                     v.persistable) for v in blk.vars.values()))
            for blk in program.blocks]


def build_both(jmodule, tmodule, **kwargs):
    """``build(**kwargs)`` of a model in both packages, asserting that the
    main, test and startup programs are the same."""
    with jfluid.unique_name.guard():
        jm = jmodule.build(**kwargs)
    with tfluid.unique_name.guard():
        tm = tmodule.build(**kwargs)
    for key in ('main', 'test', 'startup'):
        assert program_desc(tm[key]) == program_desc(jm[key]), key
    return jm, tm


def zero_dropout(*programs):
    """dropout_prob 0 on every dropout op: the packages' RNG streams
    cannot match."""
    for prog in programs:
        for op in prog.global_block().ops:
            if op.type == 'dropout':
                op.attrs['dropout_prob'] = 0.0


def _biases_before_batch_norm(program):
    """Parameters added (``elementwise_add`` Y) to the input of a
    training-mode batch_norm."""
    ops = program.global_block().ops
    made_by = {n: op for op in ops for n in op.output_arg_names}
    params = {p.name for p in program.all_parameters()}
    out = []
    for op in ops:
        if op.type != 'batch_norm' or op.attrs.get('is_test') or \
                op.attrs.get('use_global_stats'):
            continue
        src = made_by.get(op.input('X')[0])
        if src is not None and src.type == 'elementwise_add' and \
                src.input('Y')[0] in params:
            out.append(src.input('Y')[0])
    return sorted(out)


def _norm_rel(got, want):
    want = np.asarray(want, np.float64)
    diff = np.linalg.norm(np.asarray(got, np.float64) - want)
    return diff / max(np.linalg.norm(want), 1e-30)


class ModelParity(object):
    """A model built in both packages, its JAX startup run, and every
    persistable var handed to the port's scope by
    ``persistables_from_numpy`` before each run, so that each step and
    each request starts from the same state on both sides.

    ``tol`` (each stated by the model's test):
      loss: relative error of the loss;
      grad: each trainable parameter's |dg| / |g| (2-norms);
      grad_all: the same over all gradients together;
      accum: each optimizer accumulator (velocity, Adam moments) after the
        step, |d| / |v|;
      stats: each batch-norm running mean and variance after the step;
      param: each parameter after the step; under Adam, whose first step
        moves an element by lr g / (|g| + 3e-7) whatever the scale of its
        gradient (so one whose gradient is rounding noise moves by up to lr
        either way), none by more than 2 lr, and over the elements whose
        |g| is at least 1e-3 of the parameter's largest, the root mean
        square of the difference over lr;
      serve: each served fetch, |d| / |v|;
      null: for a bias added just before a training-mode batch norm, which
        subtracts it again, so that its gradient is 0 up to rounding: the
        largest |g| on each side, as a fraction of the model's largest.
        Rounding noise has no direction to compare: Adam moves such a bias
        by up to lr either way, so its update is held within 2 lr and its
        moments are not compared.
    """

    def __init__(self, jm, tm):
        self.jm, self.tm = jm, tm
        self.jscope = jfluid.Scope()
        self.jexe = jfluid.Executor(jfluid.CPUPlace())
        self.jexe.run(jm['startup'], scope=self.jscope)
        self.texe = tfluid.Executor(tfluid.CPUPlace())
        self.tscope = tfluid.Scope()
        main = tm['main']
        self.state = [v.name for v in main.list_vars() if v.persistable]
        self.params = [p.name for p in main.all_parameters() if p.trainable]
        self.stats = sorted(
            n for op in main.global_block().ops if op.type == 'batch_norm'
            for n in op.input('Mean') + op.input('Variance'))
        self.null = _biases_before_batch_norm(main)
        self.adam = any(op.type == 'adam' for op in main.global_block().ops)
        self._lr_names = sorted(set(
            n for op in main.global_block().ops
            if op.type in ('sgd', 'momentum', 'adam')
            for n in op.input('LearningRate')))
        self.accums = sorted(
            v.name for v in main.list_vars()
            if getattr(v, '_accumulator_for', None) not in (None, ) +
            tuple(self.null))

    @staticmethod
    def _within(key, err, tol, what):
        assert err <= tol[key], (what, key, err, tol[key])

    def _sync(self):
        tfluid.persistables_from_numpy(
            self.tm['main'],
            {n: np.asarray(self.jscope.find_var(n).value())
             for n in self.state}, scope=self.tscope,
            place=tfluid.CPUPlace())

    @staticmethod
    def _feeds(feed):
        """(JAX feed, port feed): ``feed`` itself for both, or, when it is a
        function of the fluid package (LoD feeds are each package's own
        LoDTensor), its value for each."""
        if callable(feed):
            return feed(jfluid), feed(tfluid)
        return feed, feed

    def serve(self, feed, fetch, tol):
        """Run the test programs on ``feed`` and compare ``fetch``."""
        self._sync()
        jfeed, tfeed = self._feeds(feed)
        want = self.jexe.run(self.jm['test'], feed=jfeed, fetch_list=fetch,
                             scope=self.jscope)
        got = self.texe.run(self.tm['test'], feed=tfeed, fetch_list=fetch,
                            scope=self.tscope)
        for name, w, g in zip(fetch, want, got):
            w = np.asarray(w)
            assert g.shape == w.shape and np.isfinite(g).all(), name
            self._within('serve', _norm_rel(g, w), tol, name)
        return got

    def step(self, feed, tol):
        """One training step on each side from the same state: the loss,
        every trainable gradient, then the updated accumulators, batch-norm
        statistics and parameters.  Returns the loss."""
        self._sync()
        fetch = [self.tm['loss'].name] + [p + '@GRAD' for p in self.params]
        jfeed, tfeed = self._feeds(feed)
        want = self.jexe.run(self.jm['main'], feed=jfeed, fetch_list=fetch,
                             scope=self.jscope)
        got = self.texe.run(self.tm['main'], feed=tfeed, fetch_list=fetch,
                            scope=self.tscope)
        loss_w, loss_g = float(np.asarray(want[0])[0]), float(got[0][0])
        assert np.isfinite(loss_g)
        self._within('loss', abs(loss_g - loss_w) / abs(loss_w), tol, 'loss')
        grads = dict(zip(self.params, (np.asarray(w) for w in want[1:])))
        diff_sq = norm_sq = 0.0
        top = max(float(np.abs(np.asarray(w)).max()) for w in want[1:])
        for name, w, g in zip(self.params, want[1:], got[1:]):
            w = np.asarray(w, np.float64)
            if name in self.null:
                self._within('null', max(np.abs(w).max(), np.abs(g).max()) /
                             top, tol, name + '@GRAD')
                continue
            assert g.shape == w.shape and np.abs(w).max() > 0, name
            self._within('grad', _norm_rel(g, w), tol, name + '@GRAD')
            diff_sq += np.square(g - w).sum()
            norm_sq += np.square(w).sum()
        self._within('grad_all', np.sqrt(diff_sq / norm_sq), tol,
                     'all gradients')
        lr = max(float(np.asarray(self.jscope.find_var(n).value()).max())
                 for n in self._lr_names)
        for name in self.null:
            g = self.tscope.find_var(name).value().numpy()
            w = np.asarray(self.jscope.find_var(name).value())
            assert np.abs(g - w).max() <= 2 * lr * (1 + 1e-3), name
        for group, key in ((self.accums, 'accum'), (self.stats, 'stats'),
                           ([p for p in self.params if p not in self.null],
                            'param')):
            for name in group:
                g = self.tscope.find_var(name).value().numpy()
                w = np.asarray(self.jscope.find_var(name).value())
                if key == 'param' and self.adam:
                    d = np.abs(g - w)
                    assert d.max() <= 2 * lr * (1 + 1e-3), name
                    gw = np.abs(grads[name])
                    d = d[gw >= 1e-3 * gw.max()].astype(np.float64)
                    self._within(key, np.sqrt(np.mean(np.square(d))) / lr,
                                 tol, name)
                else:
                    self._within(key, _norm_rel(g, w), tol, name)
        return loss_g
