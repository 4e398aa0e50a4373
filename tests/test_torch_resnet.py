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
"""

import numpy as np
import pytest

from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu_torch.models import resnet as torch_resnet

from test_torch_cv_ops import ModelParity, build_both

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
