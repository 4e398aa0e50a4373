"""The PyTorch port's VGG-16 (batch norm and dropout) held against the JAX
package on the CPU at the shape of ``tests/test_models.py`` (3 x 32 x 32,
10 classes, batch 2): the same programs, the test program in parity, and
one Adam step (lr 0.001) with ``dropout_prob`` set to 0 on every dropout op
of both packages' training programs (their RNG streams cannot match), the
state handed over from the JAX scope by ``persistables_from_numpy``.

Tolerances (``ModelParity``; ratios of 2-norms unless said): served
softmax 1e-5 (the test program normalizes with the running statistics and
scales dropout deterministically: rounding only); for the step, loss 1e-5,
batch-norm statistics 1e-4, each gradient 3e-2 and all of them 1e-2,
Adam's moments 3e-2 (measured: 3.4e-3, 3.1e-3 and 6.3e-3): batch norm over
a batch of 2 (the 2-D one after the first fc normalizes 2 values a
channel) amplifies the convolutions' rounding differences, and a ReLU or
max-pool input within rounding of a tie can take the other branch
(``test_torch_resnet``).  Parameters: the root mean square difference of
the well-determined elements 1e-3 of lr (measured 1.9e-5); the conv and fc
biases that a batch norm subtracts again have gradients of rounding noise,
at most 1e-4 of the model's largest gradient (measured 7e-6).
"""

import numpy as np

from paddle_tpu.models import vgg as jax_vgg
from paddle_tpu_torch.models import vgg as torch_vgg

from test_torch_cv_ops import ModelParity, build_both, zero_dropout

CFG = dict(class_dim=10, image_shape=(3, 32, 32), lr=0.001)
TOL = dict(loss=1e-5, grad=3e-2, grad_all=1e-2, accum=3e-2, stats=1e-4,
           param=1e-3, serve=1e-5, null=1e-4)


def _feed(seed, batch=2):
    rng = np.random.RandomState(seed)
    return {'img': rng.standard_normal((batch, ) + CFG['image_shape']).astype(
                'float32'),
            'label': rng.randint(0, 10, size=(batch, 1)).astype('int64')}


def test_vgg16_builds_serves_and_trains_like_jax():
    jm, tm = build_both(jax_vgg, torch_vgg, **CFG)
    types = [op.type for op in tm['main'].global_block().ops]
    assert types.count('conv2d') == 13 and types.count('batch_norm') == 14
    assert types.count('dropout') == 10
    bn_2d = [op for op in tm['main'].global_block().ops
             if op.type == 'batch_norm'][-1]
    assert len(tm['main'].global_block().var(bn_2d.input('X')[0]).shape) == 2
    model = ModelParity(jm, tm)
    pred, = model.serve(_feed(1), [tm['prediction'].name], TOL)
    assert pred.shape == (2, 10)
    zero_dropout(jm['main'], tm['main'])
    loss = model.step(_feed(2), TOL)
    assert np.isfinite(loss)
    assert len(model.null) == 14  # 13 conv biases and the first fc's
