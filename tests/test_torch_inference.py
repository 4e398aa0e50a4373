"""The PyTorch port's inference path held against the JAX package on the
CPU: ``proto_serde`` (each model's ``build()`` programs serialize to the
JAX package's bytes; LoD-tensor streams byte for byte, the BF16 enum
among them), ``save_inference_model`` / ``load_inference_model`` across
the two packages in both directions, the separate and combined parameter
files, the misassigned-stream rejection, the JAX package's earlier JSON
artifacts, ``Program.prune`` / ``inference_optimize``,
``InferenceTranspiler`` (batch norm folded into the conv) and
``Float16Transpiler`` at bf16 and fp16 (the program's ops and vars, the
converted params, the outputs), and ``run_eval_multi`` over a transpiled
program.

Tolerances: a loaded model's f32 predictions, 1e-5 (the same f32
arithmetic up to summation order); folded filters and biases, 1e-6
relative (the port folds in f64 and rounds once, the JAX package folds in
f32); the bf16 program's outputs against the JAX package's bf16 program,
2e-2 (one bf16 step; ``tests/test_torch_amp.py`` measures the
distribution), against f32, 3e-2 (``tests/test_float16_transpiler.py``'s
bound).
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import proto_serde as jserde
from paddle_tpu.fluid import program_serde as jprogram_serde
from paddle_tpu.models import (transformer as jtransformer, mnist as jmnist,
                               resnet as jresnet, vgg as jvgg,
                               stacked_lstm as jstacked_lstm,
                               seq2seq as jseq2seq, ctr as jctr,
                               word2vec as jword2vec)

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import proto_serde as tserde
from paddle_tpu_torch.models import (transformer as ttransformer,
                                     mnist as tmnist, resnet as tresnet,
                                     vgg as tvgg,
                                     stacked_lstm as tstacked_lstm,
                                     seq2seq as tseq2seq, ctr as tctr,
                                     word2vec as tword2vec)

F32_TOL = 1e-5
FOLD_RTOL = 1e-6
BF16_TOL = 2e-2
HALF_VS_F32 = 3e-2

MODELS = {
    'transformer': (jtransformer, ttransformer, 'build', dict(
        src_vocab=100, trg_vocab=100, max_len=16, n_layer=2, n_head=4,
        d_model=64, d_ff=128)),
    'mnist': (jmnist, tmnist, 'build', {}),
    'resnet': (jresnet, tresnet, 'build', dict(
        depth=20, class_dim=10, image_shape=(3, 32, 32), variant='cifar')),
    'resnet50': (jresnet, tresnet, 'build', dict(
        depth=50, class_dim=100, image_shape=(3, 64, 64))),
    'vgg': (jvgg, tvgg, 'build', dict(class_dim=10,
                                      image_shape=(3, 32, 32))),
    'stacked_lstm': (jstacked_lstm, tstacked_lstm, 'build', dict(
        dict_dim=100, emb_dim=32, hid_dim=128, stacked_num=3)),
    'seq2seq': (jseq2seq, tseq2seq, 'build', dict(
        src_dict_dim=50, trg_dict_dim=50, embedding_dim=16,
        encoder_size=16, decoder_size=16)),
    'seq2seq_decode': (jseq2seq, tseq2seq, 'build_decode', dict(
        src_dict_dim=40, trg_dict_dim=40, embedding_dim=8, encoder_size=8,
        decoder_size=8, beam_size=2, max_length=4)),
    'ctr': (jctr, tctr, 'build', dict(sparse_dim=1000, embed_size=8,
                                      hidden_sizes=(16, 8))),
    'word2vec': (jword2vec, tword2vec, 'build', dict(
        dict_size=200, embed_size=16, hidden_size=32, is_sparse=True)),
}


@pytest.mark.parametrize('name', sorted(MODELS))
def test_model_programs_serialize_to_the_jax_bytes(name):
    jmod, tmod, fn, kw = MODELS[name]
    with jfluid.unique_name.guard():
        jm = getattr(jmod, fn)(**kw)
    with tfluid.unique_name.guard():
        tm = getattr(tmod, fn)(**kw)
    progs = [k for k, v in tm.items() if isinstance(v, tfluid.Program)]
    assert progs
    for key in progs:
        try:
            want = jserde.serialize_program(jm[key])
        except TypeError as e:
            # an attr the wire format has no type for (the Transformer's
            # position table, a nested list in assign_value): the port
            # refuses it as the JAX package does
            with pytest.raises(TypeError) as got:
                tm[key].serialize_to_string()
            assert str(got.value) == str(e)
            continue
        got = tm[key].serialize_to_string()
        assert got == want, (name, key)
        back = tfluid.Program.parse_from_string(got)
        assert tserde.serialize_program(back) == want, (name, key)


# ---- tensor streams ----

def _stream_cases():
    rng = np.random.RandomState(0)
    f = rng.standard_normal((3, 4)).astype('float32')
    return [
        ('f32', f, None, ()),
        ('f64', f.astype('float64'), None, ()),
        ('int64', rng.randint(0, 9, (5, 1)).astype('int64'), None,
         [[0, 2, 5]]),
        ('int32', rng.randint(0, 9, (6, )).astype('int32'), None, ()),
        ('bool', rng.rand(4) > 0.5, None, ()),
        ('scalar', np.asarray(3.5, np.float32), None, ()),
        ('bf16', f.astype(ml_dtypes.bfloat16),
         torch.from_numpy(f).to(torch.bfloat16), [[0, 1, 3]]),
        ('fp16', f.astype('float16'), None, ()),
    ]


@pytest.mark.parametrize('case', _stream_cases(), ids=lambda c: c[0])
def test_lod_tensor_streams_match_jax_byte_for_byte(case):
    name, jarr, tval, lod = case
    tval = torch.from_numpy(np.ascontiguousarray(jarr).reshape(
        jarr.shape)) if tval is None else tval
    want = jserde.serialize_lod_tensor(jarr, lod)
    assert tserde.serialize_lod_tensor(tval, lod) == want
    if name != 'bf16':  # numpy arrays go in as they are
        assert tserde.serialize_lod_tensor(jarr, lod) == want
    back, got_lod = tserde.deserialize_lod_tensor(want)
    assert back.dtype == tval.dtype and tuple(back.shape) == jarr.shape
    assert torch.equal(back, tval.cpu()) and got_lod == [list(map(
        int, l)) for l in lod]
    jback, _ = jserde.deserialize_lod_tensor(
        tserde.serialize_lod_tensor(back, lod))
    assert jback.dtype == jarr.dtype
    np.testing.assert_array_equal(np.asarray(jback, np.float64),
                                  np.asarray(jarr, np.float64))


def test_bf16_stream_carries_the_bf16_enum_and_raw_words():
    t = torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)
    blob = tserde.serialize_lod_tensor(t)
    assert blob.endswith(t.view(torch.int16).numpy().tobytes())
    desc = jserde._tensor_desc(tfluid.core.VarDesc.VarType.BF16, (3, ))
    assert desc in blob


class _FakeVar(object):
    name = 'w'
    shape = (4, 2)
    dtype = tfluid.core.VarDesc.VarType.FP32


def test_combined_load_rejects_misassigned_streams():
    from paddle_tpu_torch.fluid import io as tio
    with pytest.raises(RuntimeError, match='shape'):
        tio.check_tensor_matches_var(torch.zeros(2, 4), _FakeVar(),
                                     'combined')
    with pytest.raises(RuntimeError, match='dtype'):
        tio.check_tensor_matches_var(torch.zeros(4, 2, dtype=torch.int64),
                                     _FakeVar(), 'combined')
    tio.check_tensor_matches_var(torch.zeros(4, 2), _FakeVar(), 'combined')


def test_combined_load_of_a_reordered_program_raises(tmp_path):
    tm = _convbn(tfluid)
    exe, scope = _started(tfluid, tm)
    with tfluid.scope_guard(scope):
        tfluid.io.save_params(exe, str(tmp_path), tm['main'],
                              filename='params')
        params = tm['main'].all_parameters()
        with tfluid.scope_guard(tfluid.Scope()), \
                pytest.raises(RuntimeError, match='does not match'):
            tfluid.io.load_vars(exe, str(tmp_path), vars=params[::-1],
                                filename='params')


# ---- save and load ----

def _convbn(fluid, with_bn=True, bias=False):
    """tests/test_float16_transpiler.py's net: conv (+ batch norm) + fc."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data('img', [1, 8, 8])
        conv = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                   act=None, bias_attr=None if bias else
                                   False)
        if with_bn:
            conv = fluid.layers.batch_norm(conv)
        pred = fluid.layers.fc(conv, 10, act='softmax')
    startup.random_seed = 7
    return {'main': main, 'startup': startup, 'pred': pred}


def _started(fluid, m):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(m['startup'], scope=scope)
    if any(op.type == 'batch_norm' for op in m['main'].global_block().ops):
        # running statistics away from (0, 1), so that folding shows
        for name in sorted(scope.local_var_names()):
            if name.startswith('batch_norm') and name.endswith(
                    ('.w_1', '.w_2')):
                rng = np.random.RandomState(len(name))
                v = np.abs(rng.standard_normal(4)).astype('float32') + 0.5
                scope.var(name).set_value(
                    torch.from_numpy(v) if fluid is tfluid else v)
    return exe, scope


def _image(seed=0, n=4):
    return np.random.RandomState(seed).standard_normal(
        (n, 1, 8, 8)).astype('float32')


def _load_and_run(fluid, dirname, x, **kw):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        prog, feeds, fetches = fluid.io.load_inference_model(dirname, exe,
                                                             **kw)
        out, = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches)
    return prog, feeds, fetches, np.asarray(out)


@pytest.mark.parametrize('params_filename', [None, '__params__'])
@pytest.mark.parametrize('saver', ['port', 'jax'])
def test_inference_model_crosses_packages(tmp_path, saver, params_filename):
    src, dst = (tfluid, jfluid) if saver == 'port' else (jfluid, tfluid)
    m = _convbn(src)
    exe, scope = _started(src, m)
    with src.scope_guard(scope):
        names = src.io.save_inference_model(
            str(tmp_path), ['img'], [m['pred']], exe, main_program=m['main'],
            params_filename=params_filename)
    assert names == [m['pred'].name]
    x = _image()
    _, feeds, fetches, want = _load_and_run(src, str(tmp_path), x,
                                            params_filename=params_filename)
    prog, feeds2, fetches2, got = _load_and_run(
        dst, str(tmp_path), x, params_filename=params_filename)
    assert feeds == feeds2 == ['img']
    assert [v.name for v in fetches] == [v.name for v in fetches2]
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    files = sorted(os.listdir(tmp_path))
    assert '__model__' in files
    assert (params_filename in files) == (params_filename is not None)


def test_port_writes_the_jax_packages_files(tmp_path):
    """The same program and values give the same files, byte for byte."""
    out = {}
    for fluid in (jfluid, tfluid):
        m = _convbn(fluid)
        exe, scope = _started(jfluid, _convbn(jfluid))
        values = {n: np.asarray(scope.find_var(n).value())
                  for n in scope.local_var_names()}
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        for n, v in values.items():
            scope.var(n).set_value(torch.from_numpy(v.copy()) if fluid is
                                   tfluid else v)
        for form in (None, 'params'):
            d = tmp_path / ('%s_%s' % (fluid.__name__, form))
            with fluid.scope_guard(scope):
                fluid.io.save_inference_model(
                    str(d), ['img'], [m['pred']], exe,
                    main_program=m['main'], params_filename=form)
            out[(fluid, form)] = {f: (d / f).read_bytes()
                                  for f in sorted(os.listdir(d))}
    for form in (None, 'params'):
        assert out[(tfluid, form)] == out[(jfluid, form)], form


def test_save_and_load_params_and_persistables(tmp_path):
    m = _convbn(tfluid)
    exe, scope = _started(tfluid, m)
    state = {n: scope.find_var(n).value().clone()
             for n in scope.local_var_names()}
    for what in ('params', 'persistables'):
        for filename in (None, 'all'):
            d = str(tmp_path / ('%s_%s' % (what, filename)))
            with tfluid.scope_guard(scope):
                getattr(tfluid.io, 'save_' + what)(exe, d, m['main'],
                                                   filename=filename)
            fresh = tfluid.Scope()
            with tfluid.scope_guard(fresh):
                getattr(tfluid.io, 'load_' + what)(exe, d, m['main'],
                                                   filename=filename)
            want = [v.name for v in m['main'].list_vars()
                    if (tfluid.io.is_parameter(v) if what == 'params' else
                        tfluid.io.is_persistable(v))]
            assert sorted(fresh.local_var_names()) == sorted(want)
            for n in want:
                assert torch.equal(fresh.find_var(n).value(), state[n]), n


def test_legacy_json_artifact_loads(tmp_path):
    """The JAX package's earlier format: a JSON wrapper around a
    structural-JSON program, and npy parameter files."""
    m = _convbn(jfluid)
    exe, scope = _started(jfluid, m)
    prog = m['main'].prune([m['pred']]).inference_optimize()
    meta = {'program': jprogram_serde.serialize_program(prog).decode(),
            'feed_var_names': ['img'], 'fetch_var_names': [m['pred'].name]}
    (tmp_path / '__model__').write_text(json.dumps(meta))
    for v in prog.list_vars():
        if v.persistable:
            np.save(str(tmp_path / v.name), np.asarray(
                scope.find_var(v.name).value()))
            os.rename(str(tmp_path / v.name) + '.npy',
                      str(tmp_path / v.name))
    x = _image()
    with jfluid.scope_guard(scope):
        want, = exe.run(prog, feed={'img': x}, fetch_list=[m['pred']])
    _, feeds, fetches, got = _load_and_run(tfluid, str(tmp_path), x)
    assert feeds == ['img'] and fetches[0].name == m['pred'].name
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_prune_and_inference_optimize_match_jax():
    jm, tm = _convbn(jfluid), _convbn(tfluid)
    for fluid, m in ((jfluid, jm), (tfluid, tm)):
        with fluid.program_guard(m['main'], m['startup']):
            lbl = fluid.layers.data('lbl', [1], dtype='int64')
            loss = fluid.layers.mean(fluid.layers.cross_entropy(m['pred'],
                                                                lbl))
            fluid.optimizer.SGD(0.1).minimize(loss)
    v0 = tm['main']._version
    want = jm['main'].prune([jm['pred']]).inference_optimize()
    got = tm['main'].prune([tm['pred']]).inference_optimize()
    assert tm['main']._version == v0  # prune copies
    assert got.serialize_to_string() == jserde.serialize_program(want)
    assert [op.type for op in got.global_block().ops] == [
        'conv2d', 'batch_norm', 'mul', 'elementwise_add', 'softmax']
    assert got.global_block().ops[1].attrs['is_test'] is True
    assert tfluid.io.get_inference_program(
        [tm['pred']], tm['main']).serialize_to_string() == \
        got.serialize_to_string()


# ---- transpilers ----

def _transpiled(fluid, dirname, half=None, fold=True, x=None):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        prog, feeds, fetches = fluid.io.load_inference_model(dirname, exe)
        v0 = prog._version
        if fold:
            fluid.InferenceTranspiler().transpile(prog, scope=scope)
        if half:
            fluid.Float16Transpiler().transpile(
                prog, scope=scope, dtype=half, feeded_var_names=feeds,
                fetch_var_names=fetches)
        assert fluid is jfluid or (fold or half) is None or \
            prog._version > v0
        out = None
        if x is not None:
            out, = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches)
    return prog, scope, feeds, fetches, out


def _saved(tmp_path, **kw):
    m = _convbn(jfluid, **kw)
    exe, scope = _started(jfluid, m)
    with jfluid.scope_guard(scope):
        jfluid.io.save_inference_model(str(tmp_path), ['img'], [m['pred']],
                                       exe, main_program=m['main'])
    return str(tmp_path)


def _scope_np(scope, name):
    v = scope.find_var(name).value()
    if isinstance(v, torch.Tensor):
        return v.float().numpy(), str(v.dtype).replace('torch.', '')
    a = np.asarray(v)
    return a.astype(np.float32), str(a.dtype)


def _program_view(prog):
    blk = prog.global_block()
    return ([(op.type, dict(op.inputs), dict(op.outputs)) for op in blk.ops],
            sorted((v.name, tuple(v.shape), v.dtype, v.persistable)
                   for v in blk.vars.values()))


@pytest.mark.parametrize('bias', [False, True])
def test_inference_transpiler_folds_like_jax(tmp_path, bias):
    d = _saved(tmp_path, bias=bias)
    x = _image(1)
    jprog, jscope, _, _, jout = _transpiled(jfluid, d, x=x)
    tprog, tscope, _, _, tout = _transpiled(tfluid, d, x=x)
    assert _program_view(tprog) == _program_view(jprog)
    assert 'batch_norm' not in [op.type for op in tprog.global_block().ops]
    for v in tprog.list_vars():
        if v.persistable:
            g, gd = _scope_np(tscope, v.name)
            w, wd = _scope_np(jscope, v.name)
            assert gd == wd, v.name
            np.testing.assert_allclose(g, w, rtol=FOLD_RTOL, atol=1e-7,
                                       err_msg=v.name)
    _, _, _, _, unfolded = _transpiled(tfluid, d, fold=False, x=x)
    np.testing.assert_allclose(tout, np.asarray(jout), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(tout, unfolded, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize('half', ['bfloat16', 'float16'])
def test_float16_transpiler_matches_jax(tmp_path, half):
    d = _saved(tmp_path)
    x = _image(0)
    _, _, _, _, ref = _transpiled(tfluid, d, fold=False, x=x)
    jprog, jscope, _, _, jout = _transpiled(jfluid, d, half=half, x=x)
    tprog, tscope, feeds, _, tout = _transpiled(tfluid, d, half=half, x=x)
    assert _program_view(tprog) == _program_view(jprog)
    assert tout.dtype == np.float32 and tout.shape == ref.shape
    np.testing.assert_allclose(tout, np.asarray(jout, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    assert np.abs(tout - ref).max() < HALF_VS_F32
    assert np.allclose(tout.sum(axis=1), 1.0, atol=1e-2)
    blk = tprog.global_block()
    halves = [n for n in blk.vars if n.endswith('.fp16') and
              blk.vars[n].persistable]
    assert halves
    for n in halves:
        g, gd = _scope_np(tscope, n)
        w, wd = _scope_np(jscope, n)
        assert gd == wd == half, n
        np.testing.assert_array_equal(g, w, err_msg=n)
        for op in blk.ops:
            if op.type != 'cast':
                assert n[:-len('.fp16')] not in op.input_arg_names
    casts = [op for op in blk.ops if op.type == 'cast']
    assert any(op.input('X')[0] == feeds[0] for op in casts)


def test_batch_norm_keeps_f32_inputs_without_fold(tmp_path):
    d = _saved(tmp_path)
    x = np.zeros((2, 1, 8, 8), 'float32')
    jprog, _, _, _, jout = _transpiled(jfluid, d, half='bfloat16',
                                       fold=False, x=x)
    tprog, _, feeds, _, tout = _transpiled(tfluid, d, half='bfloat16',
                                           fold=False, x=x)
    assert _program_view(tprog) == _program_view(jprog)
    bn = [op for op in tprog.global_block().ops if op.type == 'batch_norm']
    assert bn
    for arg in bn[0].input_arg_names:
        assert not arg.endswith('.fp16') or arg.startswith(tuple(feeds))
    assert np.isfinite(tout).all()
    np.testing.assert_allclose(tout, np.asarray(jout, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_transpiled_bf16_params_save_as_the_jax_package_does(tmp_path):
    d = _saved(tmp_path / 'model')
    out = {}
    for fluid in (jfluid, tfluid):
        prog, scope, feeds, fetches, _ = _transpiled(fluid, d,
                                                     half='bfloat16')
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            fluid.io.save_persistables(exe, str(tmp_path / fluid.__name__),
                                       prog, filename='params')
        out[fluid] = (tmp_path / fluid.__name__ / 'params').read_bytes()
    assert out[tfluid] == out[jfluid]


def test_run_eval_multi_over_a_transpiled_program(tmp_path):
    d = _saved(tmp_path)
    lots = [_image(s, 3) for s in range(4)]
    prog, scope, feeds, fetches, _ = _transpiled(tfluid, d, half='bfloat16')
    exe = tfluid.Executor(tfluid.CPUPlace())
    stacked, = exe.run_eval_multi(
        prog, feed_list=[{feeds[0]: x} for x in lots], fetch_list=fetches,
        scope=scope)
    assert stacked.shape == (4, 3, 10) and stacked.dtype == np.float32
    for i, x in enumerate(lots):
        one, = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches,
                       scope=scope)
        np.testing.assert_array_equal(stacked[i], one)
