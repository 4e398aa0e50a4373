"""The PyTorch port's MNIST models held against the JAX package on the CPU:
the MLP (784-200-200-10, tanh) and the LeNet-style conv net (two
conv + relu + max-pool blocks over 1 x 28 x 28) build the same programs and
train three Adam steps (lr 0.001, batch 8) in parity, every persistable var
handed over from the JAX scope before each step; the test programs serve
in parity.

Tolerances (``ModelParity``, ratios of 2-norms), the same f32 arithmetic
up to summation order: loss and served softmax 1e-5; gradients and Adam's
moments 1e-4 (measured: 1.5e-6 and below; the second moment squares the
gradient); the updated parameters' root mean square difference 1e-4 of lr
(measured 1.8e-6).  With these inputs no ReLU or max-pool
input of the conv net lies within rounding of a tie, which would move the
gradients below it by more (``test_torch_resnet``).
"""

import numpy as np
import pytest

from paddle_tpu.models import mnist as jax_mnist
from paddle_tpu_torch.models import mnist as torch_mnist

from test_torch_cv_ops import ModelParity, build_both

CONFIGS = {'mlp': dict(nn_type='mlp', img_shape=(784, ), lr=0.001),
           'conv': dict(nn_type='conv', img_shape=(1, 28, 28), lr=0.001)}
TOL = dict(loss=1e-5, grad=1e-4, grad_all=1e-4, accum=1e-4, stats=0.0,
           param=1e-4, serve=1e-5, null=0.0)


def _feed(cfg, seed, batch=8):
    rng = np.random.RandomState(seed)
    return {'img': rng.uniform(-1, 1, (batch, ) + cfg['img_shape']).astype(
                'float32'),
            'label': rng.randint(0, 10, size=(batch, 1)).astype('int64')}


@pytest.mark.parametrize('nn_type', ['mlp', 'conv'])
def test_mnist_trains_and_serves_like_jax(nn_type):
    cfg = CONFIGS[nn_type]
    jm, tm = build_both(jax_mnist, torch_mnist, **cfg)
    types = [op.type for op in tm['main'].global_block().ops]
    assert types.count('adam') == 6  # three weights and three biases
    assert ('tanh' in types) == (nn_type == 'mlp')
    assert ('pool2d' in types) == (nn_type == 'conv')
    model = ModelParity(jm, tm)
    losses = [model.step(_feed(cfg, 30 + step), TOL) for step in range(3)]
    assert all(np.isfinite(losses))
    pred, = model.serve(_feed(cfg, 40), [tm['prediction'].name], TOL)
    assert pred.shape == (8, 10)
