"""The PyTorch port's common tensor, shape, reduce, loss and metric layers,
``nets``' three helpers and path K1's Transformer in plain layers, held
against the JAX package on the CPU: each layer (``fluid/layers/nn.py``,
``ops.py``, ``tensor.py``, ``metric_op.py``) and each ``nets`` helper builds
the same main and startup ProgramDescs in both packages (``program_desc``:
op types, slots, attrs; var names, shapes, dtypes, LoD levels,
persistability); and ``chip_smoke.ops_transformer_programs`` at 2 layers,
d_model 32, 4 heads, seq 8 builds the same programs, and from the JAX
package's startup state (handed over by ``persistables_from_numpy``) takes
two Adam steps like it.

Tolerance: the ProgramDescs equal; the two Adam steps' losses at rtol 1e-5,
the first step's gradients within 1e-4 of each one's max|g|, and every
persistable var after each step at rtol / atol 1e-4 (the transformer
tests' bounds: f32 sums in another order through attention, layer norm and
Adam's division).
"""

import os
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid

from test_torch_cv_ops import program_desc

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def _data(fluid, name, shape, dtype='float32', lod_level=0):
    return fluid.layers.data(name=name, shape=shape, dtype=dtype,
                             lod_level=lod_level)


def _nn(fluid):
    L = fluid.layers
    x = _data(fluid, 'x', [3, 4, 5])
    img = _data(fluid, 'img', [4, 6, 6])
    y = _data(fluid, 'y', [5, 2])
    L.mul(L.reshape(x, [-1, 20]), L.create_parameter([20, 7], 'float32',
                                                     name='mw'))
    L.mul(x, y, x_num_col_dims=2)
    L.transpose(x, perm=[0, 2, 1, 3])
    L.flatten(x, axis=2)
    L.split(x, num_or_sections=2, dim=2)
    L.split(x, num_or_sections=[1, 3, 1], dim=-1)
    for reduce in (L.reduce_mean, L.reduce_max, L.reduce_min,
                   L.reduce_prod):
        reduce(x)
        reduce(x, dim=1)
        reduce(x, dim=[1, -1], keep_dim=True)
    L.l2_normalize(x, axis=-1)
    L.l2_normalize(x, axis=None, epsilon=1e-6)
    for mode in ('all', 'channel', 'element'):
        L.prelu(img, mode)
    L.maxout(img, groups=2)
    L.pad(y, paddings=[0, 0, 1, 2, 0, 1], pad_value=0.5)
    L.pad2d(img, paddings=[1, 0, 2, 1], mode='reflect')
    L.stack([y, y], axis=1)
    L.stack(y)
    L.unstack(x, axis=1)
    L.squeeze(_data(fluid, 'sq', [1, 3, 1]), axes=[1, 3])
    ids = _data(fluid, 'ids', [1], dtype='int64')
    L.scatter(y, ids, y)
    L.slice(x, axes=[1, 3], starts=[1, -3], ends=[100, 2**31 - 1])
    L.shape(x)
    label = _data(fluid, 'label', [1], dtype='int64')
    hot = L.one_hot(label, depth=5)
    L.label_smooth(hot, epsilon=0.2)
    L.label_smooth(hot, prior_dist=L.create_parameter([5], 'float32',
                                                      name='prior'))
    L.smooth_l1(y, y)
    L.smooth_l1(y, y, inside_weight=y, outside_weight=y, sigma=2.0)
    prob = _data(fluid, 'prob', [1])
    L.log_loss(prob, prob, epsilon=1e-3)
    L.multiplex([y, y, y], _data(fluid, 'mux', [1], dtype='int32'))
    L.random_crop(img, shape=[3, 3])
    L.crop(x, shape=[2, 2, 3, 4], offsets=[0, 1, 1, 0])
    L.crop(x, shape=y)
    L.dice_loss(L.softmax(_data(fluid, 'seg', [8, 5])),
                _data(fluid, 'seg_label', [8, 1], dtype='int64'))
    L.rank_loss(prob, prob, prob)


def _ops(fluid):
    L = fluid.layers
    x = _data(fluid, 'x', [3, 4])
    L.cumsum(x)
    L.cumsum(x, axis=1, exclusive=True, reverse=True)
    L.uniform_random([2, 3], min=-2.0, max=2.0, seed=3)
    L.gaussian_random([2, 3], mean=1.0, std=0.5)
    L.uniform_random_batch_size_like(x, [1, 6], output_dim_idx=0)
    L.gaussian_random_batch_size_like(x, [5, 1], input_dim_idx=0,
                                      output_dim_idx=1, std=2.0)


def _tensor(fluid):
    L = fluid.layers
    x = _data(fluid, 'x', [3, 4])
    L.create_tensor('float32', name='made')
    L.create_tensor('int64', persistable=True)
    L.create_parameter([4, 2], 'float32', name='p',
                       default_initializer=fluid.initializer.Constant(0.5))
    L.create_parameter([2], 'float32', is_bias=True,
                       attr=fluid.ParamAttr(name='b'))
    L.sum([x, x, x])
    L.sum(x)
    L.argmin(x, axis=1)
    L.argmax(x)
    L.argsort(x)
    L.argsort(x, axis=0)
    L.reverse(x, axis=1)
    L.reverse(x, axis=[0, 1])


def _metric(fluid):
    L = fluid.layers
    probs = _data(fluid, 'probs', [2])
    label = _data(fluid, 'label', [1], dtype='int64')
    L.auc(probs, label)
    L.auc(probs, label, num_thresholds=64)
    L.precision_recall(probs, label)
    L.precision_recall(probs, label, class_number=2)
    score = _data(fluid, 'score', [1])
    L.positive_negative_pair(score, L.cast(label, 'float32'),
                             _data(fluid, 'qid', [1], dtype='int64'))


def _nets(fluid):
    q = _data(fluid, 'q', [6, 16])
    k = _data(fluid, 'k', [5, 16])
    v = _data(fluid, 'v', [5, 8])
    fluid.nets.scaled_dot_product_attention(q, k, v)
    fluid.nets.scaled_dot_product_attention(q, k, k, num_heads=4)
    fluid.nets.scaled_dot_product_attention(q, k, v, num_heads=2,
                                            dropout_rate=0.1)
    fluid.nets.glu(_data(fluid, 'g', [3, 8]), dim=-1)
    fluid.nets.glu(_data(fluid, 'g2', [4, 3]), dim=1)
    words = _data(fluid, 'words', [1], dtype='int64', lod_level=1)
    emb = fluid.layers.embedding(words, size=[30, 8])
    fluid.nets.sequence_conv_pool(emb, num_filters=6, filter_size=3)
    fluid.nets.sequence_conv_pool(emb, num_filters=4, filter_size=2,
                                  act='tanh', pool_type='sum')


def _built(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        build(fluid)
    return main, startup


@pytest.mark.parametrize('build', [_nn, _ops, _tensor, _metric, _nets],
                         ids=['nn', 'ops', 'tensor', 'metric_op', 'nets'])
def test_layers_build_the_jax_program_desc(build):
    jmain, jstart = _built(jfluid, build)
    tmain, tstart = _built(tfluid, build)
    assert program_desc(tmain) == program_desc(jmain)
    assert program_desc(tstart) == program_desc(jstart)


def test_every_new_layer_and_helper_is_built_here():
    """The layers of the slice each appear in a build function above."""
    import inspect
    import re
    sources = ''.join(inspect.getsource(f)
                      for f in (_nn, _ops, _tensor, _metric, _nets))
    layers = ['mul', 'transpose', 'flatten', 'split', 'reduce_mean',
              'reduce_max', 'reduce_min', 'reduce_prod', 'l2_normalize',
              'prelu', 'maxout', 'pad', 'pad2d', 'stack', 'unstack',
              'squeeze', 'scatter', 'slice', 'shape', 'label_smooth',
              'smooth_l1', 'log_loss', 'multiplex', 'random_crop', 'crop',
              'dice_loss', 'rank_loss', 'cumsum', 'uniform_random',
              'gaussian_random', 'uniform_random_batch_size_like',
              'gaussian_random_batch_size_like', 'create_tensor',
              'create_parameter', 'sum', 'argmin', 'argmax', 'argsort',
              'reverse', 'auc', 'precision_recall',
              'positive_negative_pair', 'glu',
              'scaled_dot_product_attention', 'sequence_conv_pool']
    for name in layers:
        assert re.search(r'\.%s\b' % name, sources), name
        owner = tfluid.nets if name in ('glu', 'sequence_conv_pool',
                                        'scaled_dot_product_attention') \
            else tfluid.layers
        assert callable(getattr(owner, name)), name


SMALL = dict(n_layer=2, d_model=32, n_head=4, d_ff=64, vocab=50, seq=8)


def test_plain_layer_transformer_two_adam_steps_like_jax():
    """Path K1's program at 2 layers, d_model 32, 4 heads, seq 8: the same
    programs in both packages, then two Adam steps from the JAX package's
    startup state."""
    with jfluid.unique_name.guard():
        jm = chip_smoke.ops_transformer_programs(jfluid, **SMALL)
    with tfluid.unique_name.guard():
        tm = chip_smoke.ops_transformer_programs(tfluid, **SMALL)
    for key in ('main', 'startup', 'test'):
        assert program_desc(tm[key]) == program_desc(jm[key]), key
    ops = [op.type for op in tm['test'].global_block().ops]
    for op in ('transpose', 'matmul', 'label_smooth', 'reduce_mean',
               'softmax_with_cross_entropy'):
        assert op in ops, op
    assert 'flash_attention' not in ops
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jm['startup'].random_seed = 7
    jexe.run(jm['startup'], scope=jscope)
    state = [v.name for v in jm['main'].list_vars() if v.persistable]
    tscope = tfluid.Scope()
    tfluid.persistables_from_numpy(
        tm['main'], {n: np.asarray(jscope.find_var(n).value())
                     for n in state}, scope=tscope, place=tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    params = [p.name for p in tm['main'].all_parameters()]
    fetch = [tm['loss'].name] + [p + '@GRAD' for p in params]
    rng = np.random.RandomState(5)
    for step in range(2):
        feed = chip_smoke.ops_transformer_batch(rng, 3, SMALL['seq'],
                                                SMALL['vocab'])
        want = jexe.run(jm['main'], feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tm['main'], feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5)
        if step == 0:
            for name, w, g in zip(params, want[1:], got[1:]):
                w = np.asarray(w)
                assert np.abs(g).max() > 0, name
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=1e-4 * np.abs(w).max(),
                                           err_msg=name)
        for name in state:
            np.testing.assert_allclose(
                tscope.find_var(name).value().numpy(),
                np.asarray(jscope.find_var(name).value()), rtol=1e-4,
                atol=1e-4, err_msg='%s after step %d' % (name, step + 1))
