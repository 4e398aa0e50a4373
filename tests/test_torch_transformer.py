"""The PyTorch port's Transformer slice held against the JAX package on the
CPU: each op the slice runs, one-op program against one-op program, and the
whole model (n_layer=2, d_model=64) with the JAX package's parameters carried
across by ``params_from_numpy``.

Tolerance: the per-op lowerings compute the same f32 arithmetic as XLA's CPU
backend up to summation order, hence 1e-5.  The whole slice runs 2+2 layers
of f32 matmuls, layer norms and softmaxes whose rounding differs between
XLA and torch's CPU kernels, hence rtol/atol 1e-4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.models import transformer as torch_transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_one_op(fluid, op_type, inputs, outputs, attrs):
    """Build a one-op program in ``fluid`` (either package), feed
    ``inputs`` {slot: (name, array)}, fetch ``outputs`` {slot: name}."""
    prog = fluid.Program()
    blk = prog.global_block()
    feed = {}
    for name, arr in inputs.values():
        blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
        feed[name] = arr
    for name in outputs.values():
        blk.create_var(name=name, dtype='float32')
    blk.append_op(type=op_type,
                  inputs={s: [n] for s, (n, _) in inputs.items()},
                  outputs={s: [n] for s, n in outputs.items()},
                  attrs=attrs)
    exe = fluid.Executor(fluid.CPUPlace())
    return exe.run(prog, feed=feed, fetch_list=list(outputs.values()),
                   scope=fluid.Scope())


def _case(name):
    rng = np.random.RandomState(11)
    f32 = lambda *s: rng.standard_normal(s).astype('float32')
    if name == 'mul':
        return ('mul', {'X': ('x', f32(2, 3, 8)), 'Y': ('y', f32(8, 5))},
                {'Out': 'out'}, {'x_num_col_dims': 2, 'y_num_col_dims': 1})
    if name == 'layer_norm':
        return ('layer_norm',
                {'X': ('x', f32(2, 3, 8)), 'Scale': ('s', f32(8)),
                 'Bias': ('b', f32(8))},
                {'Y': 'y', 'Mean': 'mean', 'Variance': 'var'},
                {'epsilon': 1e-5, 'begin_norm_axis': 2})
    if name == 'lookup_table':
        ids = rng.randint(0, 10, size=(2, 5)).astype('int64')
        ids[0, 1] = 3
        return ('lookup_table', {'Ids': ('ids', ids), 'W': ('w', f32(10, 6))},
                {'Out': 'out'}, {'padding_idx': 3})
    if name == 'softmax_with_cross_entropy':
        lbl = rng.randint(0, 7, size=(2, 5, 1)).astype('int64')
        lbl[1, 2, 0] = -100
        return ('softmax_with_cross_entropy',
                {'Logits': ('logits', f32(2, 5, 7)), 'Label': ('lbl', lbl)},
                {'Softmax': 'sm', 'Loss': 'loss'},
                {'soft_label': False, 'ignore_index': -100})
    if name == 'elementwise_add':
        return ('elementwise_add', {'X': ('x', f32(2, 3, 4, 5)),
                                    'Y': ('y', f32(3, 4))},
                {'Out': 'out'}, {'axis': 1})
    if name == 'reshape':
        return ('reshape', {'X': ('x', f32(2, 3, 8))}, {'Out': 'out'},
                {'shape': [0, -1, 2]})
    if name == 'unsqueeze':
        return ('unsqueeze', {'X': ('x', f32(2, 3))}, {'Out': 'out'},
                {'axes': [0, 2]})
    if name == 'assign_value':
        vals = f32(2, 4)
        return ('assign_value', {}, {'Out': 'out'},
                {'shape': [2, 4], 'dtype': 5, 'values': vals})
    raise KeyError(name)


@pytest.mark.parametrize('name', [
    'mul', 'layer_norm', 'lookup_table', 'softmax_with_cross_entropy',
    'elementwise_add', 'reshape', 'unsqueeze', 'assign_value'])
def test_op_matches_jax_lowering(name):
    op_type, inputs, outputs, attrs = _case(name)
    want = _run_one_op(jfluid, op_type, inputs, outputs, attrs)
    got = _run_one_op(tfluid, op_type, inputs, outputs, attrs)
    for w, g in zip(want, got):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


SMALL = dict(src_vocab=100, trg_vocab=100, max_len=16, n_layer=2, n_head=4,
             d_model=64, d_ff=128)


def _params(program):
    return [(p.name, tuple(p.shape)) for p in program.all_parameters()]


def test_transformer_slice_matches_jax():
    with jax_unique_name.guard():
        jm = jax_transformer.build(**SMALL)
    with tfluid.unique_name.guard():
        tm = torch_transformer.build(**SMALL)
    assert _params(tm['test']) == _params(jm['test'])

    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jm['startup'], scope=jscope)
    arrays = {name: np.asarray(jscope.find_var(name).value())
              for name, _ in _params(jm['test'])}
    tscope = tfluid.Scope()
    tfluid.params_from_numpy(tm['test'], arrays, scope=tscope,
                             place=tfluid.CPUPlace())

    rng = np.random.RandomState(4)
    feed = {k: rng.randint(1, SMALL['trg_vocab'], size=(3, 16)).astype(
        'int64') for k in jm['feeds']}
    jloss, jpred = jexe.run(jm['test'], feed=feed,
                            fetch_list=[jm['loss'], jm['prediction']],
                            scope=jscope)
    tloss, tpred = tfluid.Executor(tfluid.CPUPlace()).run(
        tm['test'], feed=feed, fetch_list=[tm['loss'], tm['prediction']],
        scope=tscope)
    np.testing.assert_allclose(tloss, np.asarray(jloss), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tpred, np.asarray(jpred), rtol=1e-4,
                               atol=1e-4)


def test_transformer_startup_runs_in_port():
    with tfluid.unique_name.guard():
        tm = torch_transformer.build(**SMALL)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tm['startup'], scope=scope)
    for name, shape in _params(tm['test']):
        value = scope.find_var(name).value()
        assert tuple(value.shape) == shape and torch.isfinite(value).all()
    ln_scale = [n for n, _ in _params(tm['test'])
                if n.startswith('layer_norm') and n.endswith('.w_0')]
    assert ln_scale and torch.all(scope.find_var(ln_scale[0]).value() == 1)


@pytest.mark.parametrize('fault', ['missing', 'unknown', 'shape', 'dtype'])
def test_params_from_numpy_rejects(fault):
    with tfluid.unique_name.guard():
        tm = torch_transformer.build(**SMALL)
    arrays = {name: np.zeros(shape, 'float32')
              for name, shape in _params(tm['test'])}
    first = next(iter(arrays))
    if fault == 'missing':
        del arrays[first]
    elif fault == 'unknown':
        arrays['no_such_param'] = np.zeros(1, 'float32')
    elif fault == 'shape':
        arrays[first] = np.zeros((1, ) + arrays[first].shape, 'float32')
    else:
        arrays[first] = arrays[first].astype('float64')
    scope = tfluid.Scope()
    with pytest.raises(ValueError):
        tfluid.params_from_numpy(tm['test'], arrays, scope=scope,
                                 place=tfluid.CPUPlace())
    assert scope.local_var_names() == []


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = ('import sys, paddle_tpu_torch, '
            'paddle_tpu_torch.models.transformer, '
            'paddle_tpu_torch.fluid.backward, '
            'paddle_tpu_torch.fluid.optimizer, '
            'paddle_tpu_torch.fluid.clip, paddle_tpu_torch.fluid.regularizer, '
            'paddle_tpu_torch.ops.kernels.flash_attention, '
            'paddle_tpu_torch.ops.kernels.lstm, '
            'paddle_tpu_torch.ops.sequence_ops, '
            'paddle_tpu_torch.ops.metric_ops, '
            'paddle_tpu_torch.models.stacked_lstm, '
            'paddle_tpu_torch.fluid.flags, paddle_tpu_torch.fluid.lod_tensor, '
            'paddle_tpu_torch.fluid.shape_policy, '
            'paddle_tpu_torch.fluid.layers.sequence, '
            'paddle_tpu_torch.fluid.layers.metric_op, '
            'paddle_tpu_torch.fluid.nets, paddle_tpu_torch.models.mnist, '
            'paddle_tpu_torch.models.resnet, paddle_tpu_torch.models.vgg, '
            'paddle_tpu_torch.ops.activation_ops, '
            'paddle_tpu_torch.ops.nn_ops, '
            'paddle_tpu_torch.ops.optimizer_ops, '
            'paddle_tpu_torch.models.seq2seq, '
            'paddle_tpu_torch.fluid.layers.control_flow, '
            'paddle_tpu_torch.ops.control_flow_ops, '
            'paddle_tpu_torch.ops.beam_search_ops, '
            'paddle_tpu_torch.ops.tensor_ops, paddle_tpu_torch.ops.math_ops, '
            'paddle_tpu_torch.ops.sparse, paddle_tpu_torch.ops.loss_ops, '
            'paddle_tpu_torch.dataset.ctr, paddle_tpu_torch.models.ctr, '
            'paddle_tpu_torch.models.word2vec, '
            'paddle_tpu_torch.fluid.amp, paddle_tpu_torch.fluid.io, '
            'paddle_tpu_torch.fluid.proto_serde, '
            'paddle_tpu_torch.fluid.program_serde, '
            'paddle_tpu_torch.fluid.transpiler, '
            'paddle_tpu_torch.fluid.transpiler.inference_transpiler, '
            'paddle_tpu_torch.fluid.transpiler.float16_transpiler, '
            'paddle_tpu_torch.fluid.transpiler.memory_optimization_transpiler, '
            'paddle_tpu_torch.fluid.trace, paddle_tpu_torch.fluid.profiler, '
            'chip_smoke, '
            'profile_torch_slice, profile_ctr_merge, '
            'profile_amp_resnet_grads, probe_bench_widths; '
            'bad = sorted(m for m in sys.modules if m == "jax" or '
            'm.startswith(("jax.", "paddle_tpu.")) or m == "paddle_tpu"); '
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_executor_without_place_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        tfluid.Executor()


def test_feed_shape_mismatch_names_the_var():
    with tfluid.unique_name.guard():
        tm = torch_transformer.build(**SMALL)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {k: np.ones((2, 15), 'int64') for k in tm['feeds']}
    with pytest.raises(ValueError, match='src_ids'):
        exe.run(tm['test'], feed=feed, fetch_list=[tm['loss']],
                scope=tfluid.Scope())


def test_scope_tensor_set_by_user_and_fetch_as_lodtensor():
    prog = tfluid.Program()
    blk = prog.global_block()
    blk.create_var(name='w', shape=(2, 3), dtype='float32', persistable=True)
    blk.create_var(name='y', dtype='float32')
    blk.append_op(type='scale', inputs={'X': ['w']}, outputs={'Out': ['y']},
                  attrs={'scale': 2.0, 'bias': 1.0})
    scope = tfluid.Scope()
    w = np.arange(6, dtype='float32').reshape(2, 3)
    scope.var('w').get_tensor().set(w, tfluid.CPUPlace())
    y, = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, fetch_list=['y'], scope=scope, return_numpy=False)
    assert isinstance(y, tfluid.LoDTensor)
    np.testing.assert_array_equal(np.asarray(y), w * 2.0 + 1.0)
