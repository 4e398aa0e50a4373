"""The PyTorch port's ResNets held against the JAX package on the CPU, at
the shapes of ``tests/test_models.py``: ResNet cifar-20 (3 x 32 x 32, 10
classes, batch 4) and ResNet-50 (3 x 64 x 64, 100 classes, batch 2), each
built the same way, trained two Momentum steps (lr 0.01, mu 0.9) and served
by its test program, every persistable var handed over from the JAX scope
by ``persistables_from_numpy`` before each run.

Tolerances (``ModelParity``; each a ratio of 2-norms): a ReLU whose input
lies within rounding of 0 can take the other branch in the other package,
and each such flip changes the gradients of every layer below it by up to
a few percent; batch norm at batch 2 and a 2 x 2 plane divides by the
standard deviation of 8 values, which amplifies the rounding differences of
the convolutions layer by layer (the forward's relative difference grows
from 1e-6 at the stem to 1e-3 at the head of ResNet-50; the JAX package's
own gradients move by up to 3% of their norm, 22% in one parameter, when
its input moves by one ulp).

- cifar-20: loss 1e-5; each gradient 3e-2 and all of them 1e-2 (without a
  flip they agree within 2e-5); velocities and parameters as the gradients
  (a batch-norm bias starts at 0, so after one step it is -lr times its
  gradient); batch-norm statistics 1e-4; served softmax and logits 1e-5.
- ResNet-50: loss 1e-3; each gradient 0.25 and all of them 0.15 (measured:
  0.11 and 0.08); velocities and parameters as the gradients; statistics
  3e-3; served softmax and logits 1e-5 (the test program normalizes with
  the running statistics: no batch of 8 to amplify).
- ResNet-50 well conditioned: batch 8 at 64 x 64, so that the last stage's
  batch norm sees 32 values a channel, one Momentum step held to the
  cifar-20 bounds (``TOL['cifar']``), so that the wide bound above cannot
  hide a fault.  The same step in f64 (the port's program made f64 on the
  CPU, ``check_grad_f64.f64_program``) tells which package errs where the
  two disagree: each gradient's |d| / |v| from f64 in the port is held to
  the cifar-20 bound (3e-2) and to no more than the JAX package's own.
"""

import os
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu_torch.models import resnet as torch_resnet

from test_torch_cv_ops import ModelParity, build_both

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from check_grad_f64 import f64_program  # noqa: E402

CIFAR = dict(depth=20, class_dim=10, image_shape=(3, 32, 32), lr=0.01,
             variant='cifar')
RESNET50 = dict(depth=50, class_dim=100, image_shape=(3, 64, 64), lr=0.01)
TOL = {
    'cifar': dict(loss=1e-5, grad=3e-2, grad_all=1e-2, accum=3e-2,
                  stats=1e-4, param=3e-2, serve=1e-5, null=0.0),
    'resnet50': dict(loss=1e-3, grad=0.25, grad_all=0.15, accum=0.25,
                     stats=3e-3, param=0.25, serve=1e-5, null=0.0),
}


def _feed(cfg, batch, seed):
    rng = np.random.RandomState(seed)
    return {'img': rng.standard_normal(
                (batch, ) + cfg['image_shape']).astype('float32'),
            'label': rng.randint(0, cfg['class_dim'],
                                 size=(batch, 1)).astype('int64')}


def test_resnet50_builds_the_jax_programs_at_full_width():
    """The bench's ResNet-50 (224 x 224, 1000 classes, Momentum) and its
    SGD form."""
    jm, tm = build_both(jax_resnet, torch_resnet)
    types = [op.type for op in tm['main'].global_block().ops]
    assert types.count('conv2d') == types.count('conv2d_grad') == 53
    assert types.count('batch_norm') == types.count('batch_norm_grad') == 53
    assert types.count('momentum') == len(
        [p for p in tm['main'].all_parameters() if p.trainable]) == 161
    n_params = sum(int(np.prod(p.shape))
                   for p in tm['main'].all_parameters() if p.trainable)
    assert n_params == 25557032
    _, tm = build_both(jax_resnet, torch_resnet, use_momentum=False,
                       **RESNET50)
    assert 'sgd' in [op.type for op in tm['main'].global_block().ops]


@pytest.mark.parametrize('name', ['cifar', 'resnet50'])
def test_resnet_trains_and_serves_like_jax(name):
    cfg, batch = (CIFAR, 4) if name == 'cifar' else (RESNET50, 2)
    tol = TOL[name]
    jm, tm = build_both(jax_resnet, torch_resnet, **cfg)
    model = ModelParity(jm, tm)
    assert model.accums and len(model.stats) == 2 * (21 if name == 'cifar'
                                                     else 53)
    losses = [model.step(_feed(cfg, batch, 10 + step), tol)
              for step in range(2)]
    assert all(np.isfinite(losses))
    # the served logits: the softmax's input
    softmax = [op for op in tm['test'].global_block().ops
               if op.type == 'softmax'][-1]
    pred, logits = model.serve(_feed(cfg, batch, 20),
                               [tm['prediction'].name, softmax.input('X')[0]],
                               tol)
    assert pred.shape == (batch, cfg['class_dim'])
    np.testing.assert_allclose(pred.sum(1), np.ones(batch), rtol=1e-5)


def test_resnet50_well_conditioned_step_like_jax():
    """One Momentum step of ResNet-50 at batch 8 (32 values a channel in
    the last stage, against 8 at batch 2), at the cifar-20 bounds."""
    jm, tm = build_both(jax_resnet, torch_resnet, **RESNET50)
    loss = ModelParity(jm, tm).step(_feed(RESNET50, 8, 30), TOL['cifar'])
    assert np.isfinite(loss)


def test_resnet50_well_conditioned_step_nearer_f64_than_jax():
    """The batch-8 step's loss and gradients in f64 (the port on the CPU):
    the port's f32 step is held to it, each gradient within the cifar-20
    bound and no further from it than the JAX package's."""
    import paddle_tpu_torch.fluid as tfluid
    jm, tm = build_both(jax_resnet, torch_resnet, **RESNET50)
    model = ModelParity(jm, tm)
    feed = _feed(RESNET50, 8, 30)
    fetch = [tm['loss'].name] + [p + '@GRAD' for p in model.params]
    state = {n: np.asarray(model.jscope.find_var(n).value())
             for n in model.state}
    model._sync()
    port = model.texe.run(tm['main'], feed=feed, fetch_list=fetch,
                          scope=model.tscope)
    jax_out = model.jexe.run(jm['main'], feed=feed, fetch_list=fetch,
                             scope=model.jscope)
    scope64 = tfluid.Scope()
    for name, arr in state.items():
        scope64.var(name).set_value(torch.from_numpy(
            arr.astype(np.float64) if arr.dtype == np.float32 else
            arr.copy()))
    f64 = tfluid.Executor(tfluid.CPUPlace()).run(
        f64_program(tm['main']),
        feed=dict(feed, img=feed['img'].astype(np.float64)),
        fetch_list=fetch, scope=scope64)

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return np.linalg.norm(got - want) / np.linalg.norm(want)

    def overall(got, want):
        return np.sqrt(sum(np.square(np.float64(g) - w).sum()
                           for g, w in zip(got, want)) /
                       sum(np.square(np.float64(w)).sum() for w in want))

    # printed (pytest -s): each pair's loss, worst and overall gradient
    # |d| / |v|
    for what, got, want in (('port vs JAX', port, jax_out),
                            ('port vs f64', port, f64),
                            ('JAX vs f64', jax_out, f64)):
        print('resnet50 batch 8: %s: loss %.3g, worst gradient %.4f, all '
              'gradients %.4f' % (what, rel(got[0], want[0]),
                                  max(rel(g, w) for g, w in
                                      zip(got[1:], want[1:])),
                                  overall(got[1:], want[1:])))
    assert rel(port[0], f64[0]) <= TOL['cifar']['loss']
    for name, p, j, r in zip(model.params, port[1:], jax_out[1:], f64[1:]):
        err, jax_err = rel(p, r), rel(j, r)
        assert err <= TOL['cifar']['grad'], (name, err)
        assert err <= jax_err, (name, err, jax_err)
