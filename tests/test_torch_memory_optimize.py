"""The PyTorch port's memory plan held against the JAX package on the CPU:
``memory_optimize``'s ``_releasable`` and stats against the JAX package's
(as sets of names) on the elementwise chain of
``tests/test_memory_optimize.py``, MNIST, a 2-layer Transformer, the
cifar-20 ResNet and NMT (whose sub-blocks test the protection at depth);
the release plan bitwise (fetches and every persistable var after a step,
with the plan, with the block refused and ``_releasable`` unset, and with
the block refused after ``memory_optimize``) for each of those families
plus CTR; live bytes on the chain as the JAX package's tests measure them
(a probe op reading the tensors alive, run in a block that must run
eagerly, the counterpart of the JAX package's host-op probe); the plan's
protections; ``memory_analysis``.

Tolerance: none.  Sets of names are equal, results bitwise equal; live
bytes are bounded as in ``tests/test_memory_optimize.py`` (the plan frees
at least N - 3 of the chain's N 4 MiB intermediates, and the chain's
``temp_size_in_bytes`` is at most 3 of them).
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import ctr as jax_ctr
from paddle_tpu.models import mnist as jax_mnist
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu.models import seq2seq as jax_seq2seq
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.dataset import ctr as ctr_data
from paddle_tpu_torch.models import ctr as torch_ctr
from paddle_tpu_torch.models import mnist as torch_mnist
from paddle_tpu_torch.models import resnet as torch_resnet
from paddle_tpu_torch.models import seq2seq as torch_seq2seq
from paddle_tpu_torch.models import transformer as torch_transformer
from paddle_tpu_torch.ops import registry as tregistry

from test_torch_cv_ops import build_both
from test_torch_nmt import TRAIN as NMT, _nmt_feed
from test_torch_resnet import CIFAR, _feed as _image_feed
from test_torch_transformer import SMALL as TRANSFORMER

N_CHAIN = 8
MB = (1024, 1024)  # 4 MiB f32 an intermediate
ONE_BUF = int(np.prod(MB)) * 4


def _chain(fluid, with_probe=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=list(MB), append_batch_size=False)
        v = x
        for i in range(N_CHAIN):
            v = fluid.layers.scale(v, scale=1.0 + 1.0 / (i + 1))
        if with_probe:
            main.global_block().append_op(type='live_probe', inputs={},
                                          outputs={}, attrs={})
    return {'main': main, 'startup': startup, 'out': v}


def _mnist(fluid):
    module = jax_mnist if fluid is jfluid else torch_mnist
    with fluid.unique_name.guard():
        return module.build(nn_type='mlp', img_shape=(784, ), lr=0.001)


def _build(fluid, name):
    if name == 'chain':
        return _chain(fluid)
    if name == 'mnist':
        return _mnist(fluid)
    modules = {'transformer': (jax_transformer, torch_transformer,
                               TRANSFORMER),
               'resnet': (jax_resnet, torch_resnet, CIFAR),
               'nmt': (jax_seq2seq, torch_seq2seq, NMT),
               'ctr': (jax_ctr, torch_ctr,
                       dict(sparse_dim=1000, embed_size=8,
                            hidden_sizes=(16, 8), lr=1e-3, is_sparse=True))}
    jmod, tmod, kwargs = modules[name]
    with fluid.unique_name.guard():
        return (jmod if fluid is jfluid else tmod).build(**kwargs)


FAMILIES = ['chain', 'mnist', 'transformer', 'resnet', 'nmt']


@pytest.mark.parametrize('name', FAMILIES)
def test_releasable_and_stats_match_jax(name):
    jm, tm = _build(jfluid, name), _build(tfluid, name)
    for key in ('main', 'test') if name != 'chain' else ('main', ):
        jprog, tprog = jm[key], tm[key]
        v0 = tprog._version
        jfluid.memory_optimize(jprog)
        tfluid.memory_optimize(tprog)
        assert tprog._releasable == jprog._releasable, key
        assert tprog._memory_optimize_stats == jprog._memory_optimize_stats
        assert tprog._releasable and tprog._version == v0 + 1
        # the same set again: no new version, so no new plan
        tfluid.release_memory(tprog)
        assert tprog._version == v0 + 1
    if name == 'nmt':
        # the step blocks' reads and writes, at any depth, are protected
        inner = set()
        for blk in tm['main'].blocks[1:]:
            for op in blk.ops:
                inner.update(op.input_arg_names)
                inner.update(op.output_arg_names)
        assert inner and not inner & tm['main']._releasable


@contextlib.contextmanager
def _refused(program):
    """Every block of ``program`` refused by the capture rules, as a block
    holding an uncapturable op is: its first op's type is declared
    uncapturable for the duration."""
    op_type = program.global_block().ops[0].type
    saved = tregistry._UNCAPTURABLE.get(op_type)
    tregistry.declare_uncapturable(op_type, 'refused by the test')
    try:
        yield
    finally:
        if saved is None:
            tregistry._UNCAPTURABLE.pop(op_type)
        else:
            tregistry._UNCAPTURABLE[op_type] = saved


def _feeds(name, fluid, seed):
    rng = np.random.RandomState(seed)
    if name == 'chain':
        return {'x': rng.standard_normal(MB).astype('float32')}
    if name == 'mnist':
        return {'img': rng.uniform(-1, 1, (8, 784)).astype('float32'),
                'label': rng.randint(0, 10, (8, 1)).astype('int64')}
    if name == 'transformer':
        return {k: rng.randint(1, TRANSFORMER['trg_vocab'],
                               size=(3, 16)).astype('int64')
                for k in ('src_ids', 'trg_ids', 'lbl_ids')}
    if name == 'resnet':
        return _image_feed(CIFAR, 4, seed)
    if name == 'nmt':
        return _nmt_feed(fluid, seed, 4)
    return ctr_data.zipf_batch(rng, 64, 1000)


def _step(tm, name, state, mode):
    """Two runs of ``tm['main']`` from ``state``: the fetches and every
    persistable var after them.  ``mode``: 'plan' (the block's release
    plan), 'refused' (the block refused, ``_releasable`` unset: nothing
    freed) or 'refused_optimized' (refused after ``memory_optimize``)."""
    import copy
    prog = tm['main']
    if mode == 'refused_optimized':
        prog = prog.clone()
        tfluid.memory_optimize(prog)
        assert prog._releasable
    else:
        assert getattr(prog, '_releasable', None) is None
    fetch = tm['out'] if name == 'chain' else tm['loss']
    scope = tfluid.Scope()
    tfluid.persistables_from_numpy(prog, copy.deepcopy(state), scope=scope,
                                   place=tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    ctx = _refused(prog) if mode != 'plan' else contextlib.nullcontext()
    with ctx:
        got = [exe.run(prog, feed=_feeds(name, tfluid, seed),
                       fetch_list=[fetch], scope=scope)[0]
               for seed in (5, 6)]
    block = exe.cached_blocks()[-1]
    assert (block.refusal is None) == (mode == 'plan')
    released = sum(len(v) for v in block._release.values())
    assert released if mode != 'refused' else not released
    return got + [scope.find_var(n).value().numpy().copy()
                  for n in sorted(state)]


@pytest.mark.parametrize('name', FAMILIES + ['ctr'])
def test_release_plan_is_bitwise(name):
    jm, tm = _build(jfluid, name), _build(tfluid, name)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jm['startup'], scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name).value())
             for v in tm['main'].list_vars() if v.persistable}
    want = _step(tm, name, state, 'refused')
    for mode in ('plan', 'refused_optimized'):
        got = _step(tm, name, state, mode)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=mode)


# ---- live bytes on the chain ----

_PROBE = {}


def _live_bytes():
    """Bytes of every distinct tensor storage alive in the process."""
    seen = {}
    for obj in gc.get_objects():
        if issubclass(type(obj), torch.Tensor) and obj.device.type == 'cpu':
            st = obj.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


@pytest.fixture
def live_probe():
    """A 'live_probe' op that samples the live bytes as it runs: it reads
    host state, so a block holding it must run eagerly, as the JAX
    package's host-op probe makes its block run eagerly."""
    def lowering(ctx, op):
        _PROBE['bytes'] = _live_bytes()

    tregistry.register_lowering('live_probe')(lowering)
    tregistry.declare_uncapturable('live_probe', 'reads host state')
    try:
        yield _PROBE
    finally:
        tregistry._LOWERINGS.pop('live_probe')
        tregistry._UNCAPTURABLE.pop('live_probe')


def _run_chain(optimize):
    m = _chain(tfluid, with_probe=True)
    if optimize:
        tfluid.memory_optimize(m['main'])
    exe = tfluid.Executor(tfluid.CPUPlace())
    x = np.ones(MB, 'float32')
    _PROBE.clear()
    scope = tfluid.Scope()
    got, = exe.run(m['main'], feed={'x': x}, fetch_list=[m['out']],
                   scope=scope)
    assert exe.cached_blocks()[-1].refusal is not None
    return _PROBE['bytes'], got


def test_eager_path_release_plan_frees_dead_vars(live_probe):
    bytes_plain, out_plain = _run_chain(optimize=False)
    bytes_opt, out_opt = _run_chain(optimize=True)
    np.testing.assert_array_equal(out_opt, out_plain)
    # without the plan every chain intermediate is alive at the probe;
    # with it, all but the fetched tail are gone
    assert bytes_plain - bytes_opt >= (N_CHAIN - 3) * ONE_BUF, (
        bytes_plain, bytes_opt)


def test_memory_optimize_after_first_run_still_takes_effect(live_probe):
    """memory_optimize bumps the program's version, so a block planned
    before the pass is planned again."""
    m = _chain(tfluid, with_probe=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    feed = {'x': np.ones(MB, 'float32')}
    exe.run(m['main'], feed=feed, fetch_list=[m['out']], scope=scope)
    bytes_before = _PROBE['bytes']
    tfluid.memory_optimize(m['main'])
    exe.run(m['main'], feed=feed, fetch_list=[m['out']], scope=scope)
    assert exe.compile_count == 2
    assert bytes_before - _PROBE['bytes'] >= (N_CHAIN - 3) * ONE_BUF, (
        bytes_before, _PROBE['bytes'])


def test_plan_frees_dead_vars_without_the_pass(live_probe):
    """A block that is not refused frees at last use without the pass,
    as XLA's buffer assignment gives the JAX package's jitted blocks that
    reuse: the probe, read here through a lowering the capture rules
    accept, sees the chain's intermediates gone."""
    m = _chain(tfluid, with_probe=True)
    saved = tregistry._UNCAPTURABLE.pop('live_probe')
    try:
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(m['main'], feed={'x': np.ones(MB, 'float32')},
                fetch_list=[m['out']], scope=scope)
    finally:
        tregistry._UNCAPTURABLE['live_probe'] = saved
    block = exe.cached_blocks()[-1]
    assert block.refusal is None
    assert getattr(m['main'], '_releasable', None) is None
    bytes_plan = _PROBE['bytes']
    bytes_plain, _ = _run_chain(optimize=False)
    assert bytes_plain - bytes_plan >= (N_CHAIN - 3) * ONE_BUF, (
        bytes_plain, bytes_plan)


def _nested(fluid):
    """A global op whose sub-block holds an op whose sub-block reads
    ``deep``: a read at depth 2, invisible to the global block's ops."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        cond = fluid.layers.fill_constant([1], 'bool', True)
        deep = fluid.layers.fill_constant([1], 'float32', 5.0)
        sink = fluid.layers.fill_constant([1], 'float32', 0.0)
        outer = main.create_block()
        inner = main.create_block()
        inner.append_op(type='scale', inputs={'X': [deep.name]},
                        outputs={'Out': [sink.name]}, attrs={'scale': 2.0})
        main.rollback()
        outer.append_op(type='conditional_block',
                        inputs={'Cond': [cond.name]},
                        outputs={'Out': [sink.name]},
                        attrs={'sub_block': inner})
        main.rollback()
        main.global_block().append_op(
            type='conditional_block', inputs={'Cond': [cond.name]},
            outputs={'Out': [sink.name]}, attrs={'sub_block': outer})
    return main, deep.name


def test_vars_read_in_nested_sub_blocks_are_protected():
    jmain, jdeep = _nested(jfluid)
    tmain, tdeep = _nested(tfluid)
    jfluid.memory_optimize(jmain)
    tfluid.memory_optimize(tmain)
    assert tdeep == jdeep and tdeep not in tmain._releasable
    assert tmain._releasable == jmain._releasable


def _protect(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[2, 4], append_batch_size=False)
        mid = fluid.layers.fc(x, 4, param_attr=fluid.ParamAttr(name='keep_w'),
                              bias_attr=False)
        out = fluid.layers.scale(mid, scale=2.0)
    return main, startup, mid, out


def test_release_plan_protects_persistables_and_fetches():
    jmain = _protect(jfluid)[0]
    main, startup, mid, out = _protect(tfluid)
    jfluid.memory_optimize(jmain)
    tfluid.memory_optimize(main)
    assert main._releasable == jmain._releasable
    assert 'keep_w' not in main._releasable
    assert mid.name in main._releasable  # the actual dead intermediate
    # the executor's plan: a fetched intermediate stays, a dead one goes
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {'x': np.arange(8, dtype='float32').reshape(2, 4)}
    got_mid, got_out = exe.run(main, feed=feed, fetch_list=[mid, out],
                               scope=scope)
    np.testing.assert_array_equal(got_out, 2 * got_mid)
    plan = exe.cached_blocks()[-1]._release
    assert not any({mid.name, 'keep_w'} & set(v) for v in plan.values())
    exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    plan = exe.cached_blocks()[-1]._release
    freed = {n for v in plan.values() for n in v}
    assert mid.name in freed and 'keep_w' not in freed


# ---- memory_analysis ----

def test_memory_analysis_of_the_chain_is_a_few_buffers():
    m = _chain(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    stats = exe.memory_analysis(m['main'], feed={'x': np.ones(MB, 'float32')},
                                fetch_list=[m['out']], scope=scope)
    # the chain's intermediates sum to N_CHAIN buffers; the plan keeps a
    # couple of them live at once
    assert stats.temp_size_in_bytes <= 3 * ONE_BUF, (
        stats.temp_size_in_bytes, N_CHAIN * ONE_BUF)
    assert stats.argument_size_in_bytes == ONE_BUF
    assert stats.output_size_in_bytes == ONE_BUF
    # the block refused and the pass not run: every intermediate stays
    with _refused(m['main']):
        exe2 = tfluid.Executor(tfluid.CPUPlace())
        plain = exe2.memory_analysis(m['main'],
                                     feed={'x': np.ones(MB, 'float32')},
                                     fetch_list=[m['out']], scope=scope)
    assert plain.temp_size_in_bytes == N_CHAIN * ONE_BUF


def test_memory_analysis_leaves_the_state_as_it_was():
    """A training program analysed before it ran: the scope's state and
    the executor's later results are those of a run without the
    analysis."""
    tm = _mnist(tfluid)
    feed = _feeds('mnist', tfluid, 3)
    runs = []
    for analyse in (False, True):
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        tm['startup'].random_seed = 7
        exe.run(tm['startup'], scope=scope)
        if analyse:
            stats = exe.memory_analysis(tm['main'], feed=feed,
                                        fetch_list=[tm['loss']], scope=scope)
            assert 0 < stats.temp_size_in_bytes
        runs.append(exe.run(tm['main'], feed=feed, fetch_list=[tm['loss']],
                            scope=scope)[0])
    np.testing.assert_array_equal(runs[0], runs[1])


def test_memory_analysis_rejects_reader_fed_programs():
    m = _chain(tfluid)
    m['main'].global_block().append_op(type='read', inputs={},
                                       outputs={}, attrs={})
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(RuntimeError, match='reader-fed'):
        exe.memory_analysis(m['main'], feed={'x': np.ones(MB, 'float32')},
                            fetch_list=[m['out']], scope=tfluid.Scope())
