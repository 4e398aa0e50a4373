"""The PyTorch port's public surface against the JAX package's: the public
names of ``fluid``, ``fluid.layers`` and ``fluid.nets`` and the lowering
registry, each with the names still pending, which must equal the lists
``ROADMAP.md`` keeps (so a gap can only close, and the roadmap's counts
stay true); and the behaviour of ``fetch_var``, ``name_scope``,
``get_var`` and ``gradients`` against the JAX package's.

The names are read in a fresh interpreter (``_fresh_surfaces``), so the
other tests' imports cannot add to them.  Tolerance: name sets exactly; fetched and gradient values at rtol 1e-6 /
atol 1e-7 (the same f32 values, or one f32 product and sum).
"""

import functools
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROADMAP = os.path.join(REPO, 'ROADMAP.md')

# the names the port does not have yet, by surface (ROADMAP.md Queue 1
# item 3a lists the same, with the item that brings each family)
PENDING = {
    'fluid': [
        'Go', 'Select', 'TPUPlace', 'channel_close', 'channel_recv',
        'channel_send', 'concurrency', 'debugger', 'make_channel'],
    'fluid.layers': [
        'conv2d_transpose', 'conv3d', 'conv3d_transpose', 'ctc_greedy_decoder',
        'dynamic_lstmp', 'edit_distance', 'hsigmoid', 'im2sequence',
        'image_resize', 'image_resize_short', 'load', 'lod_reset', 'lrn',
        'lstm_unit', 'mean_iou', 'moe_ffn', 'nce', 'pad_constant_like',
        'pool3d', 'resize_bilinear', 'roi_pool', 'row_conv', 'sampling_id',
        'sequence_concat', 'sequence_enumerate', 'sequence_erase',
        'sequence_pad', 'sequence_reshape', 'sequence_reverse',
        'sequence_slice', 'warpctc'],
    'fluid.nets': [],
    'lowerings': [
        'attention_lstm', 'bilinear_interp', 'bilinear_tensor_product',
        'context_project', 'conv2d_transpose', 'conv3d', 'conv3d_transpose',
        'conv_shift', 'cross_entropy_over_beam', 'depthwise_conv2d_transpose',
        'dynamic_conv2d', 'fake_dequantize_max_abs', 'fake_quantize_abs_max',
        'fake_quantize_range_abs_max', 'fc', 'fill',
        'fused_elemwise_activation', 'fusion_gru', 'fusion_lstm',
        'fusion_seqexpand_concat_fc', 'hierarchical_sigmoid', 'hsigmoid',
        'im2sequence', 'kmax_seq_score', 'lod_reset', 'lrn', 'lstm_unit',
        'lstmp', 'max_pool2d_with_index', 'max_pool3d_with_index', 'mean_iou',
        'minus', 'moe_ffn', 'nce', 'nearest_interp', 'pad_constant_like',
        'pool3d', 'roi_pool', 'row_conv', 'sampling_id', 'scale_sub_region',
        'sequence_concat', 'sequence_enumerate', 'sequence_erase',
        'sequence_pad', 'sequence_reshape', 'sequence_reverse',
        'sequence_slice', 'sequence_unpad', 'spp', 'sub_nested_seq', 'unpool',
        'warpctc'],
}
PORTED_LOWERINGS, REFERENCE_LOWERINGS = 192, 245


# the surfaces as a fresh interpreter sees them right after importing the
# packages: in a test process a submodule imported by another test (the
# port's fluid.parallel_executor, say) becomes a name of its package, and a
# test may register a lowering of its own
_SURFACES = r"""
import json
import paddle_tpu.fluid as jf
import paddle_tpu.ops
from paddle_tpu.ops import registry as jr
import paddle_tpu_torch.fluid as tf
import paddle_tpu_torch.ops
from paddle_tpu_torch.ops import registry as tr
pub = lambda m: sorted(n for n in dir(m) if not n.startswith('_'))
print(json.dumps({
    'fluid': [pub(jf), pub(tf)],
    'fluid.layers': [pub(jf.layers), pub(tf.layers)],
    'fluid.nets': [pub(jf.nets), pub(tf.nets)],
    'lowerings': [sorted(jr._LOWERINGS), sorted(tr._LOWERINGS)]}))
"""


@functools.lru_cache(maxsize=None)
def _fresh_surfaces():
    """{surface: (the JAX package's names, the port's)}."""
    run = subprocess.run([sys.executable, '-c', _SURFACES], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS='cpu'))
    assert run.returncode == 0, run.stderr[-3000:]
    return {k: (set(ref), set(port))
            for k, (ref, port) in json.loads(
                run.stdout.strip().splitlines()[-1]).items()}


@pytest.mark.parametrize('surface', ['fluid', 'fluid.layers', 'fluid.nets'])
def test_public_names_pending_are_the_listed_ones(surface):
    ref, port = _fresh_surfaces()[surface]
    assert sorted(ref - port) == PENDING[surface]


def test_lowerings_pending_are_the_listed_ones():
    ref, port = _fresh_surfaces()['lowerings']
    assert sorted(ref - port) == PENDING['lowerings']
    assert len(ref) == REFERENCE_LOWERINGS
    assert len(ref & port) == PORTED_LOWERINGS == \
        REFERENCE_LOWERINGS - len(PENDING['lowerings'])


def _roadmap_lists():
    """{surface: [names]} from ROADMAP.md's "pending ``<surface>``
    (<count>):" bullets, each checked against its count."""
    text = open(ROADMAP).read()
    out = {}
    for m in re.finditer(r'^\s*- pending `([\w.]+)` \((\d+)\):(.*?)'
                         r'(?=^\s*- |^\s*$)', text, re.M | re.S):
        names = re.findall(r'`([\w.]+)`', m.group(3))
        assert len(names) == int(m.group(2)), m.group(1)
        out[m.group(1)] = sorted(names)
    return out


def test_roadmap_lists_the_same_pending_names_and_counts():
    assert _roadmap_lists() == PENDING
    text = open(ROADMAP).read()
    assert ('%d of the reference\'s %d lowerings' %
            (PORTED_LOWERINGS, REFERENCE_LOWERINGS)) in text


def test_small_public_names():
    assert tfluid.Tensor is tfluid.LoDTensor
    assert tfluid.is_compiled_with_tpu() is False
    assert isinstance(tfluid.is_compiled_with_cuda(), bool)
    attr = tfluid.WeightNormParamAttr(dim=1, name='w', learning_rate=0.5)
    assert (attr.dim, attr.name, attr.learning_rate) == (1, 'w', 0.5)
    assert isinstance(attr, tfluid.ParamAttr)
    assert tfluid.LoDTensorArray is tfluid.core.LoDTensorArray
    assert tfluid.gradients is tfluid.backward.gradients
    assert tfluid.calc_gradient is tfluid.backward.calc_gradient
    assert tfluid.GradientClipByGlobalNorm is \
        tfluid.clip.GradientClipByGlobalNorm
    assert tfluid.save_persistables is tfluid.io.save_persistables
    assert tfluid.get_inference_program is tfluid.io.get_inference_program


def _fc_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        with fluid.name_scope('block'):
            with fluid.name_scope():
                y = fluid.layers.fc(x, size=3,
                                    param_attr=fluid.ParamAttr(name='w'),
                                    bias_attr=fluid.ParamAttr(name='b'))
        loss = fluid.layers.mean(y)
    return main, startup, x, loss


def test_name_scope_get_var_fetch_var_and_gradients_like_jax():
    from test_torch_cv_ops import program_desc
    jmain, jstart, jx, jloss = _fc_program(jfluid)
    tmain, tstart, tx, tloss = _fc_program(tfluid)
    # name_scope names nothing: the programs are the JAX package's
    assert program_desc(tmain) == program_desc(jmain)
    assert not tfluid.framework._name_scope_stack
    # get_var: the global block's var, from the given or default program
    assert tfluid.get_var('w', tmain) is tmain.global_block().var('w')
    with tfluid.program_guard(tmain):
        assert tfluid.get_var('b') is tmain.global_block().var('b')
    for fluid, prog in ((jfluid, jmain), (tfluid, tmain)):
        with pytest.raises(ValueError):
            fluid.get_var('missing', prog)
    # fetch_var: a persistable var straight from the scope
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    tfluid.persistables_from_numpy(
        tmain, {n: np.asarray(jscope.find_var(n).value()) for n in 'wb'},
        scope=tscope, place=tfluid.CPUPlace())
    for name in 'wb':
        want = jfluid.fetch_var(name, jscope)
        got = tfluid.fetch_var(name, tscope)
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        got_lt = tfluid.fetch_var(name, tscope, return_numpy=False)
        assert isinstance(got_lt, tfluid.LoDTensor)
        np.testing.assert_allclose(np.asarray(got_lt), want, rtol=1e-6)
    got = tfluid.fetch_var('w', tscope)
    got[...] = 0.0  # the caller's copy: the scope keeps its value
    assert np.abs(tfluid.fetch_var('w', tscope)).max() > 0
    with tfluid.scope_guard(tscope):
        np.testing.assert_array_equal(tfluid.fetch_var('b'),
                                      tfluid.fetch_var('b', tscope))
    with pytest.raises(AssertionError):
        jfluid.fetch_var('missing', jscope)
    with pytest.raises(ValueError):
        tfluid.fetch_var('missing', tscope)
    # gradients: d mean(fc(x)) / dw, run in both (a data var stops the
    # gradient: its entry is None in both)
    feed = {'x': np.random.RandomState(3).standard_normal((5, 4)).astype(
        'float32')}
    fetched = []
    for fluid, main, start, x, loss, scope, exe in (
            (jfluid, jmain, jstart, jx, jloss, jscope, jexe),
            (tfluid, tmain, tstart, tx, tloss, tscope,
             tfluid.Executor(tfluid.CPUPlace()))):
        with fluid.program_guard(main, start):
            grad, none = fluid.gradients([loss], [fluid.get_var('w'), x])
        assert grad.name == 'w@GRAD' and none is None
        fetched.append(np.asarray(exe.run(main, feed=feed,
                                          fetch_list=[grad.name],
                                          scope=scope)[0]))
    np.testing.assert_allclose(fetched[1], fetched[0], rtol=1e-6, atol=1e-7)
    assert np.abs(fetched[0]).max() > 0
