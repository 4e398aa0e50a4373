"""``softmax_with_cross_entropy(soft_label=True)`` in the PyTorch port,
held against the JAX package's lowering on the CPU: one-op programs, the
loss and the softmax forward, and the generic grad (``calc_gradient``)
with respect to the logits and the label distribution, at f32.

Tolerance 1e-5 (forward and gradients, the gradients scaled by
max(1, max|grad|)): the same f32 log-softmax arithmetic up to summation
order on both sides.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

TOL = 1e-5


@pytest.fixture(autouse=True)
def _own_names():
    """Each case names its vars afresh in both packages and leaves the
    global name counters as it found them."""
    with jfluid.unique_name.guard(), tfluid.unique_name.guard():
        yield


def _case(shape):
    rng = np.random.RandomState(5)
    logits = (3 * rng.standard_normal(shape)).astype('float32')
    label = rng.rand(*shape).astype('float32')
    label /= label.sum(-1, keepdims=True)
    return logits, label


def _program(fluid, logits, label):
    prog = fluid.Program()
    blk = prog.global_block()
    blk.create_var(name='logits', shape=logits.shape, dtype='float32')
    blk.create_var(name='label', shape=label.shape, dtype='float32')
    for n in ('sm', 'loss'):
        blk.create_var(name=n, dtype='float32')
    blk.append_op(type='softmax_with_cross_entropy',
                  inputs={'Logits': ['logits'], 'Label': ['label']},
                  outputs={'Softmax': ['sm'], 'Loss': ['loss']},
                  attrs={'soft_label': True, 'ignore_index': -100})
    return prog, {'logits': logits, 'label': label}


def _forward(fluid, logits, label):
    prog, feed = _program(fluid, logits, label)
    return [np.asarray(o) for o in fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=['loss', 'sm'], scope=fluid.Scope())]


def _grads(fluid, logits, label, cot):
    prog, feed = _program(fluid, logits, label)
    with fluid.program_guard(prog, fluid.Program()):
        blk = prog.global_block()
        cvar = blk.create_var(name='cot', shape=cot.shape, dtype='float32')
        feed['cot'] = cot
        fluid.backward.calc_gradient(
            targets=[blk.var('loss')],
            inputs=[blk.var('logits'), blk.var('label')],
            target_gradients=[cvar])
    return [np.asarray(o) for o in fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=['logits@GRAD', 'label@GRAD'],
        scope=fluid.Scope())]


@pytest.mark.parametrize('shape', [(6, 7), (2, 5, 11)],
                         ids=['2d', '3d'])
def test_soft_label_forward_and_grad_match_jax(shape):
    logits, label = _case(shape)
    want = _forward(jfluid, logits, label)
    got = _forward(tfluid, logits, label)
    assert got[0].shape == shape[:-1] + (1, ) == want[0].shape
    for w, g, name in zip(want, got, ('loss', 'softmax')):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    cot = np.random.RandomState(8).standard_normal(
        want[0].shape).astype('float32')
    for w, g, name in zip(_grads(jfluid, logits, label, cot),
                          _grads(tfluid, logits, label, cot),
                          ('logits', 'label')):
        assert g.shape == w.shape == shape and np.abs(w).max() > 0, name
        np.testing.assert_allclose(
            g, w, rtol=TOL, atol=TOL * max(1.0, np.abs(w).max()),
            err_msg=name + '@GRAD')


def test_soft_label_layer_trains_like_jax():
    """The layer form (``fluid.layers.softmax_with_cross_entropy``) in a
    two-layer program, one SGD step in both packages from the same
    weights: the loss and the updated weights agree."""
    rng = np.random.RandomState(2)
    x = rng.standard_normal((8, 5)).astype('float32')
    _, label = _case((8, 3))
    w0 = rng.standard_normal((5, 3)).astype('float32')
    out = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            xv = fluid.layers.data('x', [5])
            lv = fluid.layers.data('lbl', [3])
            logits = fluid.layers.fc(
                xv, 3, bias_attr=False,
                param_attr=fluid.ParamAttr(name='soft_w'))
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
                logits, lv, soft_label=True))
            fluid.optimizer.SGD(0.5).minimize(loss)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        if fluid is tfluid:
            tfluid.params_from_numpy(main, {'soft_w': w0}, scope=scope,
                                     place=tfluid.CPUPlace())
        else:
            scope.find_var('soft_w').set_value(w0)
        l, = exe.run(main, feed={'x': x, 'lbl': label}, fetch_list=[loss],
                     scope=scope)
        out.append((np.asarray(l),
                    np.asarray(scope.find_var('soft_w').value())))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=TOL, atol=TOL)
    assert not np.allclose(out[1][1], w0)
