"""Mixed precision in the PyTorch port held against the JAX package on the
CPU, both under ``amp_guard`` on the same seeded numpy inputs: the AMP
helpers; one-op programs and their generic grads (the dtype of every output
and ``@GRAD`` as well as its values) for ``mul``, ``elementwise_add`` with
an f32 bias, ``conv2d``, ``depthwise_conv2d``, ``batch_norm``,
``layer_norm``, ``softmax`` and ``softmax_with_cross_entropy`` through the
fused bf16 path with ``ignore_index`` rows; ``flash_attention`` at bf16
against the Pallas kernel in interpret mode; ``lstm`` under
``FLAGS_fused_lstm='always'`` at bf16 against the Pallas kernel in
interpret mode; ``compile_count`` over runs that toggle AMP; the conv net
of ``tests/test_amp.py`` trained three Adam steps with the state handed
over before each; the AMP LSTM classifier of ``tests/test_amp.py``; and the
Transformer at n_layer=2 served and trained one Adam step.

Tolerances.  Both packages round the same f32 values to bf16 (nearest
even) and both CPU backends accumulate bf16 products in f32, but their
summation orders differ, so a bf16 result may land one bf16 step (2^-8
relative) away.  Each bound is 2-5x the largest error measured over seeds
0-9 (the ``check_*`` functions below, run with each seed):
  - one-op outputs and gradients (flash_attention and lstm included):
    |got - want| <= BF16_TOL * max(1, max|want|), BF16_TOL = 2e-2 (largest
    seen 9.7e-3, elementwise_add's bf16 output; f32 results computed from
    bf16 values, such as the fused cross-entropy's loss and batch norm's
    statistics, within 5e-7);
  - whole models, ``TRAIN_TOL``, read as ``ModelParity`` reads its keys
    (test_torch_cv_ops.py) but with the loss held as |d| / max(1, |loss|)
    (``AmpParity``).  Largest seen over the conv net's three steps, the
    LSTM classifier's step and the Transformer's request and step: loss
    2.7e-3, served fetch 3.7e-4, a gradient's |dg| / |g| 0.106 (the
    Transformer), all gradients together 0.043, an Adam moment 0.19, and
    Adam's first update as RMS / lr 0.71 (it moves an element by about lr
    times the sign of its gradient, and bf16 noise flips the sign of the
    small ones).  Batch-norm statistics and the null biases do not occur in
    these models: their bounds are the one-op bound.
The f32 bounds of the other tests are neither reused nor changed here.
"""

import contextlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.ops import registry as jregistry
from paddle_tpu.models import transformer as jtransformer

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import registry as tregistry
from paddle_tpu_torch.models import transformer as ttransformer

from test_torch_cv_ops import ModelParity, build_both

BF16_TOL = 2e-2
TRAIN_TOL = dict(loss=1e-2, grad=0.25, grad_all=0.1, accum=0.4, param=1.0,
                 serve=2e-3, stats=BF16_TOL, null=BF16_TOL)


class AmpParity(ModelParity):
    """``ModelParity`` whose loss is held as the one-op results are,
    |got - want| <= tol * max(1, |want|): a bf16 softmax output near 1 is
    1 or 1 - 2^-8, so a small loss has no relative precision to compare."""

    def step(self, feed, tol):
        self._sync()
        jfeed, _ = self._feeds(feed)
        want, = self.jexe.run(self.jm['test'], feed=jfeed,
                              fetch_list=[self.jm['loss'].name],
                              scope=self.jscope)
        want = float(np.asarray(want).ravel()[0])
        got = super(AmpParity, self).step(feed, dict(tol, loss=np.inf))
        err = abs(got - want) / max(1.0, abs(want))
        self._within('loss', err, tol, 'loss')
        return got


@contextlib.contextmanager
def amp_both(on=True):
    with jfluid.amp_guard(on), tfluid.amp_guard(on):
        yield


def _np(value):
    """(dtype name, f32 numpy array) of a fetch from either package."""
    if isinstance(value, tfluid.LoDTensor):
        t = value.tensor()
        return str(t.dtype).replace('torch.', ''), t.float().numpy()
    a = np.asarray(value)
    return str(a.dtype), a.astype(np.float32)


def _close(got, want, what, tol=BF16_TOL):
    gd, g = _np(got)
    wd, w = _np(want)
    assert gd == wd, (what, gd, wd)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))
    assert err <= tol, (what, err, tol)
    return err


# ---- the helpers ----

def _helper_inputs():
    rng = np.random.RandomState(0)
    a = rng.standard_normal((5, 7)).astype('float32')
    b = rng.standard_normal((7, 3)).astype('float32')
    return a, b


def _j(a, bf16=False):
    return jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)


def _t(a, bf16=False):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if bf16 else t


@pytest.mark.parametrize('on', [False, True])
def test_amp_helpers_match_jax(on):
    a, b = _helper_inputs()
    with amp_both(on):
        assert tregistry.amp_enabled() == jregistry.amp_enabled() == on
        pairs = [
            (jregistry.amp_cast_in(_j(a), _j(b, True)),
             tregistry.amp_cast_in(_t(a), _t(b, True))),
            ((jregistry.amp_cast_out(_j(a)), ),
             (tregistry.amp_cast_out(_t(a)), )),
            ((jregistry.amp_upcast_f32(_j(a, True)), ),
             (tregistry.amp_upcast_f32(_t(a, True)), )),
            (jregistry.amp_harmonize(_j(a, True), _j(a)),
             tregistry.amp_harmonize(_t(a, True), _t(a))),
            (jregistry.amp_harmonize(_j(a), _j(a, True)),
             tregistry.amp_harmonize(_t(a), _t(a, True))),
            ((jregistry.amp_matmul(_j(a), _j(b)), ),
             (tregistry.amp_matmul(_t(a), _t(b)), )),
            ((jregistry.amp_matmul(_j(a, True), _j(b)), ),
             (tregistry.amp_matmul(_t(a, True), _t(b)), )),
        ]
        for i, (want, got) in enumerate(pairs):
            for w, g in zip(want, got):
                assert str(g.dtype).replace('torch.', '') == str(w.dtype), i
                np.testing.assert_allclose(
                    g.float().numpy(), np.asarray(w, np.float32),
                    rtol=BF16_TOL, atol=BF16_TOL, err_msg=str(i))
    assert not tregistry.amp_enabled() and not jregistry.amp_enabled()


def test_amp_guard_restores_and_enable_amp_sets():
    assert not tfluid.amp.amp_enabled()
    with tfluid.amp_guard():
        assert tfluid.amp.amp_enabled()
        with tfluid.amp_guard(False):
            assert not tfluid.amp.amp_enabled()
        assert tfluid.amp.amp_enabled()
    assert not tfluid.amp.amp_enabled()
    tfluid.enable_amp(True)
    try:
        assert tregistry.amp_enabled()
    finally:
        tfluid.enable_amp(False)


# ---- one-op programs ----

BF16_SUFFIX = '_bf16'


def _program(fluid, case):
    """A program of one op: ``inputs`` {slot: (name, array, dtype)}.  An
    input of dtype 'bfloat16' is fed f32 as ``name`` and cast to bf16 into
    ``name + BF16_SUFFIX``, which the op reads: both packages differentiate
    only vars declared floating in numpy, which bfloat16 is not, so a bf16
    activation is a declared-f32 var that holds bf16, as under AMP."""
    op_type, inputs, outputs, attrs = case
    prog = fluid.Program()
    blk = prog.global_block()
    feed, slots = {}, {}
    for slot, (name, arr, dtype) in inputs.items():
        blk.create_var(name=name, shape=arr.shape,
                       dtype='float32' if dtype == 'bfloat16' else dtype)
        feed[name] = arr
        slots[slot] = [name]
        if dtype == 'bfloat16':
            blk.create_var(name=name + BF16_SUFFIX, shape=arr.shape,
                           dtype='float32')
            blk.append_op(type='cast', inputs={'X': [name]},
                          outputs={'Out': [name + BF16_SUFFIX]},
                          attrs={'in_dtype': 5, 'out_dtype': 22})
            slots[slot] = [name + BF16_SUFFIX]
    for name in outputs.values():
        if not blk.has_var(name):
            blk.create_var(name=name, dtype='float32')
    blk.append_op(type=op_type, inputs=slots,
                  outputs={s: [n] for s, n in outputs.items()},
                  attrs=attrs)
    return prog, feed


def _wrt(case, names):
    """``names`` with each bf16 input's cast output before it."""
    bf16 = {n for n, _, d in case[1].values() if d == 'bfloat16'}
    return [m for n in names
            for m in ((n + BF16_SUFFIX, n) if n in bf16 else (n, ))]


def _run(fluid, prog, feed, fetch):
    kw = {'return_numpy': False} if fluid is tfluid else {}
    return fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch, scope=fluid.Scope(), **kw)


def _forward(fluid, case):
    prog, feed = _program(fluid, case)
    with amp_both():
        return _run(fluid, prog, feed, list(case[2].values()))


def _grads(fluid, case, slot, wrt, cot):
    wrt = _wrt(case, wrt)
    prog, feed = _program(fluid, case)
    with fluid.program_guard(prog, fluid.Program()):
        blk = prog.global_block()
        cvar = blk.create_var(name='cot', shape=cot.shape, dtype='float32')
        feed['cot'] = cot
        fluid.backward.calc_gradient(targets=[blk.var(case[2][slot])],
                                     inputs=[blk.var(n) for n in wrt],
                                     target_gradients=[cvar])
    with amp_both():
        return _run(fluid, prog, feed, [n + '@GRAD' for n in wrt])


def _one_op_case(name, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.standard_normal(s).astype('float32')
    if name == 'mul':
        return ('mul', {'X': ('x', f(4, 3, 16), 'float32'),
                        'Y': ('y', f(16, 8), 'float32')},
                {'Out': 'out'}, {'x_num_col_dims': 2}), 'Out', ['x', 'y']
    if name == 'elementwise_add':
        return ('elementwise_add', {'X': ('x', f(4, 3, 8), 'bfloat16'),
                                    'Y': ('y', f(8), 'float32')},
                {'Out': 'out'}, {'axis': -1}), 'Out', ['x', 'y']
    if name == 'conv2d':
        return ('conv2d', {'Input': ('x', f(2, 3, 8, 8), 'float32'),
                           'Filter': ('w', f(4, 3, 3, 3), 'float32')},
                {'Output': 'out'},
                {'strides': [1, 1], 'paddings': [1, 1], 'dilations': [1, 1],
                 'groups': 1}), 'Output', ['x', 'w']
    if name == 'depthwise_conv2d':
        return ('depthwise_conv2d',
                {'Input': ('x', f(2, 4, 8, 8), 'float32'),
                 'Filter': ('w', f(4, 1, 3, 3), 'float32')},
                {'Output': 'out'},
                {'strides': [2, 2], 'paddings': [1, 1], 'dilations': [1, 1],
                 'groups': 4}), 'Output', ['x', 'w']
    if name == 'batch_norm':
        return ('batch_norm',
                {'X': ('x', f(4, 3, 5, 5) * 2 + 1, 'bfloat16'),
                 'Scale': ('s', f(3), 'float32'),
                 'Bias': ('b', f(3), 'float32'),
                 'Mean': ('m', f(3), 'float32'),
                 'Variance': ('v', np.abs(f(3)) + 0.5, 'float32')},
                {'Y': 'y', 'MeanOut': 'm', 'VarianceOut': 'v',
                 'SavedMean': 'sm', 'SavedVariance': 'sv'},
                {'epsilon': 1e-5, 'momentum': 0.9}), 'Y', ['x', 's', 'b']
    if name == 'layer_norm':
        return ('layer_norm',
                {'X': ('x', f(4, 3, 16), 'bfloat16'),
                 'Scale': ('s', f(16), 'float32'),
                 'Bias': ('b', f(16), 'float32')},
                {'Y': 'y', 'Mean': 'mean', 'Variance': 'var'},
                {'epsilon': 1e-5, 'begin_norm_axis': 2}), 'Y', ['x', 's',
                                                              'b']
    if name == 'softmax':
        return ('softmax', {'X': ('x', f(4, 3, 16) * 3, 'bfloat16')},
                {'Out': 'out'}, {}), 'Out', ['x']
    if name == 'softmax_with_cross_entropy':
        n, v = 24, 96
        lbl = rng.randint(0, v, (n, 1)).astype('int64')
        lbl[:4] = -100  # ignored rows
        return ('softmax_with_cross_entropy',
                {'Logits': ('logits', f(n, v) * 3, 'bfloat16'),
                 'Label': ('lbl', lbl, 'int64')},
                {'Softmax': 'sm', 'Loss': 'loss'},
                {'soft_label': False, 'ignore_index': -100}), 'Loss', [
                    'logits']
    raise KeyError(name)


ONE_OP = ['mul', 'elementwise_add', 'conv2d', 'depthwise_conv2d',
          'batch_norm', 'layer_norm', 'softmax', 'softmax_with_cross_entropy']


def check_one_op(name, seed=0):
    """The op's outputs and its generic grad's under AMP in both packages:
    the largest error seen, over every output and gradient."""
    case, slot, wrt = _one_op_case(name, seed)
    want = _forward(jfluid, case)
    got = _forward(tfluid, case)
    errs = [_close(g, w, name + ' ' + n)
            for n, w, g in zip(case[2], want, got)]
    shape = _np(want[list(case[2]).index(slot)])[1].shape
    cot = np.random.RandomState(8 + seed).standard_normal(shape).astype(
        'float32')
    want = _grads(jfluid, case, slot, wrt, cot)
    got = _grads(tfluid, case, slot, wrt, cot)
    for n, w, g in zip(_wrt(case, wrt), want, got):
        assert np.abs(_np(w)[1]).max() > 0, n
        errs.append(_close(g, w, '%s %s@GRAD' % (name, n)))
    return max(errs)


@pytest.mark.parametrize('name', ONE_OP)
def test_one_op_under_amp_matches_jax(name):
    check_one_op(name)


def test_amp_dtypes_are_the_jax_packages():
    """The dtypes the JAX package gives, pinned: bf16 products and
    activations, f32 gradients for f32 inputs, f32 statistics and loss."""
    want = {
        'mul': (['bfloat16'], ['float32', 'float32']),
        'elementwise_add': (['bfloat16'], ['bfloat16', 'float32',
                                            'float32']),
        'conv2d': (['bfloat16'], ['float32', 'float32']),
        'depthwise_conv2d': (['bfloat16'], ['float32', 'float32']),
        'batch_norm': (['bfloat16'] + ['float32'] * 4,
                       ['bfloat16', 'float32', 'float32', 'float32']),
        'layer_norm': (['bfloat16', 'float32', 'float32'],
                       ['bfloat16', 'float32', 'float32', 'float32']),
        'softmax': (['bfloat16'], ['bfloat16', 'float32']),
        'softmax_with_cross_entropy': (['bfloat16', 'float32'],
                                       ['bfloat16', 'float32']),
    }
    for name, (outs, grads) in want.items():
        case, slot, wrt = _one_op_case(name, 0)
        got = [_np(v)[0] for v in _forward(tfluid, case)]
        assert got == outs, (name, got)
        cot = np.ones(_np(_forward(tfluid, case)[
            list(case[2]).index(slot)])[1].shape, 'float32')
        got = [_np(v)[0] for v in _grads(tfluid, case, slot, wrt, cot)]
        assert got == grads, (name, got)


def test_fused_cross_entropy_matches_f32_composition():
    """``FusedCEBf16`` against the f32 composition on the same bf16 logits,
    as ``tests/test_amp.py`` holds the JAX package's."""
    from paddle_tpu_torch.ops.loss_ops import FusedCEBf16
    rng = np.random.RandomState(11)
    n, v = 24, 96
    logits = torch.from_numpy(rng.standard_normal((n, v)).astype(
        'float32') * 3).to(torch.bfloat16).requires_grad_()
    idx = torch.from_numpy(rng.randint(0, v, (n, )))
    idx[:4] = -100
    loss, p = FusedCEBf16.apply(logits, idx, -100)
    log_p = torch.log_softmax(logits.detach().float(), -1)
    safe = torch.where(idx == -100, 0, idx)
    want = -log_p.gather(-1, safe[:, None])
    want[:4] = 0
    assert loss.dtype == torch.float32 and p.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.detach().numpy(), want.numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(p.float().detach().numpy(),
                               log_p.exp().numpy(), rtol=2e-2, atol=2e-2)
    loss.sum().backward()
    onehot = torch.nn.functional.one_hot(safe, v).float()
    want_g = log_p.exp() - onehot
    want_g[:4] = 0
    assert logits.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.grad.float().numpy(), want_g.numpy(),
                               rtol=2e-2, atol=2e-2)


# ---- the kernels' ops at bf16 ----

def _flash_case(seed):
    rng = np.random.RandomState(seed)
    qkv = {s: (s.lower(), rng.standard_normal((2, 16, 2, 64)).astype(
        'float32'), 'float32') for s in ('Q', 'K', 'V')}
    return ('flash_attention', qkv, {'Out': 'out'},
            {'causal': True, 'impl': 'pallas'}), 'Out', ['q', 'k', 'v']


def _lstm_case(seed):
    rng = np.random.RandomState(seed)
    b, t, d = 8, 5, 128
    w = (rng.standard_normal((d, 4 * d)) / np.sqrt(d)).astype('float32')
    return ('lstm', {'Input': ('x', rng.standard_normal(
        (b, t, 4 * d)).astype('float32'), 'bfloat16'),
        'Weight': ('w', w, 'float32'),
        'Bias': ('b', rng.standard_normal((1, 4 * d)).astype('float32') *
                 0.1, 'float32')},
        {'Hidden': 'h', 'Cell': 'c', 'BatchGate': 'g',
         'BatchCellPreAct': 'pre'},
        {'use_peepholes': False}), 'Hidden', ['x', 'w', 'b']


@contextlib.contextmanager
def fused_lstm(mode):
    old = jflags.FLAGS.fused_lstm, tfluid.FLAGS.fused_lstm
    jflags.FLAGS.fused_lstm = tfluid.FLAGS.fused_lstm = mode
    try:
        yield
    finally:
        jflags.FLAGS.fused_lstm, tfluid.FLAGS.fused_lstm = old


def _check_case(case, slot, wrt, seed):
    want = _forward(jfluid, case)
    got = _forward(tfluid, case)
    errs = [_close(g, w, n) for n, w, g in zip(case[2], want, got)]
    shape = _np(want[list(case[2]).index(slot)])[1].shape
    cot = np.random.RandomState(8 + seed).standard_normal(shape).astype(
        'float32')
    want = _grads(jfluid, case, slot, wrt, cot)
    got = _grads(tfluid, case, slot, wrt, cot)
    for n, w, g in zip(_wrt(case, wrt), want, got):
        assert np.abs(_np(w)[1]).max() > 0, n
        errs.append(_close(g, w, n + '@GRAD'))
    return max(errs)


def check_flash(seed=0):
    """flash_attention under AMP: f32 Q/K/V cast to bf16, the Pallas kernel
    (interpret mode) against the port's kernel path (its plain version on
    the CPU): Out bf16, Q/K/V@GRAD f32."""
    return _check_case(*_flash_case(seed), seed)


def check_lstm(seed=0):
    """lstm under AMP and FLAGS_fused_lstm='always' with a bf16 Input: the
    Pallas kernel (interpret mode) against the port's kernel path: Hidden,
    Cell and BatchCellPreAct bf16, Weight@GRAD and Bias@GRAD f32."""
    with fused_lstm('always'):
        return _check_case(*_lstm_case(seed), seed)


def test_flash_attention_bf16_matches_pallas():
    check_flash()


def test_lstm_bf16_matches_pallas():
    check_lstm()


def test_lstm_amp_dtypes():
    case, slot, wrt = _lstm_case(0)
    with fused_lstm('always'):
        outs = [_np(v)[0] for v in _forward(tfluid, case)]
        cot = np.ones((8, 5, 128), 'float32')
        grads = [_np(v)[0] for v in _grads(tfluid, case, slot, wrt, cot)]
    assert outs == ['bfloat16'] * 4
    assert grads == ['bfloat16', 'float32', 'float32', 'float32']


# ---- the compile cache ----

def _cache_program(fluid):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[8], dtype='float32')
        y = fluid.layers.fc(x, size=4)
    return prog, startup, y


def _compile_counts(fluid):
    prog, startup, y = _cache_program(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {'x': np.ones((3, 8), 'float32')}
    counts, dtypes = [], []
    for amp in (False, True, True, False, True, False):
        with fluid.amp_guard(amp):
            out, = exe.run(prog, feed=feed, fetch_list=[y], scope=scope,
                           **({'return_numpy': False}
                              if fluid is tfluid else {}))
        counts.append(exe.compile_count)
        dtypes.append(_np(out)[0])
    return counts, dtypes


def test_compile_count_under_toggled_amp_matches_jax():
    want = _compile_counts(jfluid)
    got = _compile_counts(tfluid)
    assert got == want
    assert got[0] == [2, 3, 3, 3, 3, 3]
    assert got[1] == ['float32', 'bfloat16', 'bfloat16', 'float32',
                      'bfloat16', 'float32']


def test_bf16_fetch_with_numpy_matches_jax():
    """A bf16 fetch with ``return_numpy=True`` comes back as the JAX
    package's does, an ``ml_dtypes.bfloat16`` array, bit for bit, from
    the same weights."""
    import ml_dtypes
    jprog, jstartup, jy = _cache_program(jfluid)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    prog, startup, y = _cache_program(tfluid)
    scope = tfluid.Scope()
    tfluid.persistables_from_numpy(
        prog, {v.name: np.asarray(jscope.find_var(v.name).value())
               for v in prog.list_vars() if v.persistable},
        scope=scope, place=tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {'x': np.random.RandomState(3).uniform(
        -1, 1, (3, 8)).astype('float32')}
    with jfluid.amp_guard():
        want, = jexe.run(jprog, feed=feed, fetch_list=[jy], scope=jscope)
    with tfluid.amp_guard():
        got, = exe.run(prog, feed=feed, fetch_list=[y], scope=scope)
    want = np.asarray(want)
    assert want.dtype == ml_dtypes.bfloat16
    assert got.dtype == want.dtype and got.shape == want.shape == (3, 4)
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


# ---- whole models ----

def _convnet(fluid):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[3, 16, 16], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='int64')
        c = fluid.layers.conv2d(x, num_filters=8, filter_size=3, act='relu')
        pred = fluid.layers.fc(c, size=4, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        test = prog.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return {'main': prog, 'startup': startup, 'test': test, 'loss': loss,
            'pred': pred}


def _convnet_data(seed):
    rng = np.random.RandomState(seed)
    return {'x': rng.standard_normal((16, 3, 16, 16)).astype('float32'),
            'y': (np.arange(16) % 4).astype('int64')[:, None]}


def check_convnet(seed=0, steps=3):
    mp = AmpParity(_convnet(jfluid), _convnet(tfluid))
    feed = _convnet_data(seed)
    with amp_both():
        for _ in range(steps):
            mp.step(feed, TRAIN_TOL)
    for p in mp.tm['main'].all_parameters():
        assert mp.tscope.find_var(p.name).value().dtype == torch.float32
    return mp


def test_convnet_trains_under_amp_like_jax():
    check_convnet()


def test_amp_loss_is_close_to_f32_with_the_same_weights():
    """tests/test_amp.py's check, in the port: one forward, AMP vs f32."""
    m = _convnet(tfluid)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(m['startup'], scope=scope)
    feed = _convnet_data(0)
    l32, = exe.run(m['test'], feed=feed, fetch_list=[m['loss']], scope=scope)
    with tfluid.amp_guard():
        lamp, = exe.run(m['test'], feed=feed, fetch_list=[m['loss']],
                        scope=scope)
    np.testing.assert_allclose(lamp, l32, rtol=2e-2)


def _lstm_classifier(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = fluid.layers.data('words', [1], dtype='int64', lod_level=1)
        label = fluid.layers.data('label', [1], dtype='int64')
        emb = fluid.layers.embedding(input=words, size=[50, 16])
        proj = fluid.layers.fc(input=emb, size=32 * 4)
        h, _ = fluid.layers.dynamic_lstm(input=proj, size=32 * 4)
        last = fluid.layers.sequence_last_step(input=h)
        pred = fluid.layers.fc(input=last, size=2, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=0.02).minimize(loss)
    startup.random_seed = 3
    return {'main': main, 'startup': startup, 'test': test, 'loss': loss}


def _lstm_feed(fluid):
    rng = np.random.RandomState(0)
    rows = [rng.randint(0, 50, (n, 1)) for n in (7, 12, 5, 9, 11, 6, 8, 10)]
    words = fluid.create_lod_tensor(
        np.concatenate(rows).astype('int64'), [[len(r) for r in rows]],
        fluid.CPUPlace())
    return {'words': words,
            'label': rng.randint(0, 2, (8, 1)).astype('int64')}


def check_lstm_classifier_step(seed=3):
    """One AMP step of the classifier against the JAX package."""
    jm, tm = _lstm_classifier(jfluid), _lstm_classifier(tfluid)
    jm['startup'].random_seed = tm['startup'].random_seed = seed
    mp = AmpParity(jm, tm)
    with amp_both():
        mp.step(_lstm_feed, TRAIN_TOL)
    return mp


def test_lstm_classifier_under_amp_like_jax():
    """tests/test_amp.py's AMP LSTM classifier: one step against the JAX
    package from the same state; then, from the JAX package's initial
    state, 20 steps in the port under AMP land within 0.1 of the port's f32
    training (the JAX test's bound) and of the JAX package's AMP
    training."""
    mp = AmpParity(_lstm_classifier(jfluid), _lstm_classifier(tfluid))
    start = {n: np.array(mp.jscope.find_var(n).value()) for n in mp.state}
    with amp_both():
        mp.step(_lstm_feed, TRAIN_TOL)

    def train(fluid, amp):
        m = _lstm_classifier(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        if fluid is jfluid:
            exe.run(m['startup'], scope=scope)
        else:
            tfluid.persistables_from_numpy(m['main'], start, scope=scope,
                                           place=tfluid.CPUPlace())
        feed = _lstm_feed(fluid)
        with fluid.amp_guard(amp):
            for _ in range(20):
                loss, = exe.run(m['main'], feed=feed,
                                fetch_list=[m['loss']], scope=scope)
        return float(np.asarray(loss).ravel()[0])

    l32, lamp, jamp = train(tfluid, False), train(tfluid, True), train(
        jfluid, True)
    assert l32 < 0.3, l32
    assert abs(lamp - l32) < 0.1, (lamp, l32)
    assert abs(lamp - jamp) < 0.1, (lamp, jamp)


SMALL = dict(src_vocab=100, trg_vocab=100, max_len=16, n_layer=2, n_head=4,
             d_model=64, d_ff=128)


def check_transformer(seed=0):
    jm, tm = build_both(jtransformer, ttransformer, **SMALL)
    mp = AmpParity(jm, tm)
    rng = np.random.RandomState(seed)
    feed = {k: rng.randint(1, SMALL['trg_vocab'], size=(3, 16)).astype(
        'int64') for k in jm['feeds']}
    with amp_both():
        mp.serve(feed, [tm['loss'].name], TRAIN_TOL)
        mp.step(feed, TRAIN_TOL)
    return mp


def test_transformer_serves_and_trains_under_amp_like_jax():
    check_transformer()
