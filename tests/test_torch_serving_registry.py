"""The PyTorch port's ModelRegistry, HBM arbiter, PaddlePredictor and
Inferencer held against the JAX package's on the CPU (``CPUPlace()``), and
the executor's purge of one program's blocks that eviction rests on.
Each registry case mirrors one of ``tests/test_model_registry.py`` or
``tests/test_slo_serving.py`` (the mesh and sharded-table ones excepted;
the generation ones are in ``test_torch_generation.py``); the predictor
cases mirror ``tests/test_inference_api.py``.

The models are the MNIST MLP (three inference models saved by the JAX
package, seeds 1-3, loaded by both) and the Transformer at n_layer=2 (the
JAX package's startup parameters handed to the port).  The same request
streams, made from a numpy seed, go to both registries; the fetches are
held to the JAX package's (MLP 1e-5 rtol, atol 1e-6; Transformer 1e-4, as
``test_torch_transformer`` states) and the admission, eviction, reload and
reject counts to the JAX registry's under the same byte budget.  Within
the port, eviction and reload are bitwise on the CPU.
"""

import gc
import os
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu import inference as jinference
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.fluid.contrib.memory_usage_calc import \
    memory_usage as jax_memory_usage
from paddle_tpu.models import mnist as jax_mnist
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu.serving.arbiter import HBMArbiter as JaxArbiter
from paddle_tpu.serving.arbiter import program_seed_bytes as jax_seed

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.fluid.contrib.memory_usage_calc import memory_usage
from paddle_tpu_torch.models import transformer as torch_transformer
from paddle_tpu_torch.serving.arbiter import HBMArbiter, program_seed_bytes

MLP_TOL = dict(rtol=1e-5, atol=1e-6)
TF_TOL = dict(rtol=1e-4, atol=1e-4)
# a row served in a coalesced lot against the same row alone (torch's CPU
# GEMM picks its kernel by the row count; test_torch_serving)
BATCH_TOL = dict(rtol=2e-6, atol=0)
PACKAGES = {'jax': (jfluid, jserving), 'torch': (tfluid, tserving)}
SMALL_TF = dict(src_vocab=100, trg_vocab=100, max_len=16, n_layer=2,
                n_head=4, d_model=64, d_ff=128)



@pytest.fixture(autouse=True)
def _own_names():
    """Each case names its vars afresh in both packages and leaves the
    global name counters as it found them: other files build programs in
    both packages unguarded and compare the names."""
    with jax_unique_name.guard(), tfluid.unique_name.guard():
        yield

@pytest.fixture(scope='module')
def model_dirs(tmp_path_factory):
    """Three MNIST MLP inference models, saved by the JAX package."""
    root = tmp_path_factory.mktemp('mlp_models')
    dirs = {}
    for i, name in enumerate(['mA', 'mB', 'mC']):
        d = str(root / name)
        with jax_unique_name.guard():
            m = jax_mnist.build(nn_type='mlp')
        m['startup'].random_seed = i + 1
        exe = jfluid.Executor(jfluid.CPUPlace())
        scope = jfluid.core.Scope()
        with jfluid.scope_guard(scope):
            exe.run(m['startup'])
            jfluid.io.save_inference_model(d, ['img'], [m['prediction']],
                                           exe, main_program=m['test'])
        dirs[name] = d
    return dirs


def _requests(seed, sizes):
    rng = np.random.RandomState(seed)
    return [{'img': rng.rand(n, 784).astype('float32')} for n in sizes]


def _registry(pkg, **kw):
    fluid, serving = PACKAGES[pkg]
    return serving.ModelRegistry(place=fluid.CPUPlace(), **kw)


def _standalone(pkg, d, reqs):
    fluid, serving = PACKAGES[pkg]
    eng = serving.InferenceEngine.from_saved_model(d, place=fluid.CPUPlace())
    try:
        return [eng.infer(r)[0] for r in reqs]
    finally:
        eng.stop()


def _reg_counts(m):
    return {k: m[k] for k in ('evictions', 'reloads', 'admission_rejects',
                              'overload_rejects', 'budget_bytes',
                              'resident_bytes', 'lru_order')}


# ---- seeds, memory_usage, the arbiter ----------------------------------

def test_memory_usage_and_seed_bytes_match_jax(model_dirs):
    """The arbiter's admission seed, from memory_usage, equals the JAX
    package's for the same program."""
    jprog = jserving.InferenceEngine.from_saved_model(
        model_dirs['mA'], place=jfluid.CPUPlace())._program
    tprog = tserving.InferenceEngine.from_saved_model(
        model_dirs['mA'], place=tfluid.CPUPlace())._program
    for b in (1, 8, 32):
        assert memory_usage(tprog, b) == jax_memory_usage(jprog, b)
        assert program_seed_bytes(tprog, b) == jax_seed(jprog, b)
    with pytest.raises(ValueError):
        memory_usage(tprog, 0)
    with pytest.raises(TypeError):
        memory_usage('not a program', 1)


def test_arbiter_lru_policy_and_set_budget_like_jax():
    """LRU victim selection, reload counting, budget re-pointing and the
    typed reject, step for step as the JAX package's arbiter."""
    logs = []
    for cls, err in ((JaxArbiter, jserving.HBMBudgetError),
                     (HBMArbiter, tserving.HBMBudgetError)):
        arb = cls(budget_bytes=100)
        evicted = []

        def evict_cb(name):
            evicted.append(name)
            return 40

        arb.admit('a', 40)
        arb.ensure('a', evict_cb)
        arb.admit('b', 40)
        arb.ensure('b', evict_cb)
        arb.touch('a')
        arb.admit('c', 40)
        arb.ensure('c', evict_cb)
        arb.ensure('b', evict_cb)
        arb.set_budget(30)
        with pytest.raises(err):
            arb.ensure('b', evict_cb)
        arb.set_budget(1000)
        arb.ensure('b', evict_cb)
        with pytest.raises(err):
            cls(budget_bytes=10).admit('big', 11)
        snap = arb.snapshot()
        snap.pop('audit')
        logs.append((evicted, snap, arb.is_resident('b')))
    assert logs[1] == logs[0]
    assert logs[1][0] == ['b', 'a', 'c']


def test_arbiter_audit_reports_drift():
    arb = HBMArbiter()
    arb.admit('a', 100)
    arb.ensure('a', lambda n: 0)
    audit = arb.audit(live_bytes=250)
    assert audit['accounted_bytes'] == 100 and audit['drift_bytes'] == 150
    assert arb.snapshot()['audit']['live_bytes'] == 250
    # without a card, memory_allocated has nothing to read
    assert arb.audit()['live_bytes'] == (
        torch.cuda.memory_allocated() if torch.cuda.is_available() else 0)


# ---- the registry on the MNIST MLP -------------------------------------

def test_interleaved_stream_under_forcing_budget_matches_jax(model_dirs):
    """Three models under a budget sized for about two: the interleaved
    stream forces evictions and transparent reloads with the JAX
    registry's counts; every result matches the JAX one, and equals the
    port's standalone engine bitwise."""
    reqs = _requests(0, [3, 2, 5, 1, 4])
    refs = {n: _standalone('torch', d, reqs) for n, d in model_dirs.items()}
    res = {}
    for pkg in PACKAGES:
        seed = max(program_seed_bytes(
            tserving.InferenceEngine.from_saved_model(
                d, place=tfluid.CPUPlace())._program, 32)
            for d in model_dirs.values())
        reg = _registry(pkg, hbm_budget_bytes=int(2.5 * seed))
        for name, d in model_dirs.items():
            reg.load(name, d)
        outs = {n: [] for n in model_dirs}
        with reg:
            for q in reqs:
                for name in model_dirs:
                    outs[name].append(reg.infer(name, q, timeout=30)[0])
        m = reg.metrics()
        res[pkg] = (outs, _reg_counts(m), m)
    for name in model_dirs:
        for j, (a, b) in enumerate(zip(res['jax'][0][name],
                                       res['torch'][0][name])):
            np.testing.assert_allclose(b, a, err_msg='%s %d' % (name, j),
                                       **MLP_TOL)
            assert np.array_equal(b, refs[name][j]), (name, j)
    assert res['torch'][1] == res['jax'][1]
    m = res['torch'][2]
    assert m['evictions'] >= 1 and m['reloads'] >= 1
    assert m['admission_rejects'] == 0
    assert all(m['models'][n]['router']['requests'] == len(reqs)
               and m['models'][n]['errors'] == 0 for n in model_dirs)


def test_eviction_reload_round_trip_is_bitwise(model_dirs):
    """evict_to_host copies every device tensor to the host bitwise and
    drops the blocks; the next request stages the weights back, plans
    afresh (as the JAX engine recompiles) and returns the same bits."""
    res = {}
    for pkg in PACKAGES:
        fluid, serving = PACKAGES[pkg]
        eng = serving.InferenceEngine.from_saved_model(
            model_dirs['mA'], place=fluid.CPUPlace())
        r = _requests(2, [3])[0]
        assert eng.device_footprint() == 0  # loaded in host form
        out_before, = eng.infer(r)
        live = eng.device_footprint()
        assert live > 0 and eng.hbm_footprint() == live
        compiles = eng.metrics()['compiles']
        moved, dropped = eng.evict_to_host()
        assert moved == live and dropped >= 1
        assert eng.device_footprint() == 0
        out_after, = eng.infer(r)
        assert np.array_equal(out_before, out_after)
        res[pkg] = (live, dropped, eng.metrics()['compiles'] - compiles,
                    eng.device_footprint(), out_after)
    assert res['torch'][:4] == res['jax'][:4]
    np.testing.assert_allclose(res['torch'][4], res['jax'][4], **MLP_TOL)


def _half_model(pkg, d):
    """The MLP saved in ``d`` loaded and rewritten by
    Float16Transpiler('bfloat16'), which leaves the f32 originals in the
    scope beside the bf16 copies the program reads."""
    fluid, _ = PACKAGES[pkg]
    scope = fluid.core.Scope()
    with fluid.scope_guard(scope):
        prog, feeds, fetches = fluid.io.load_inference_model(
            d, fluid.Executor(fluid.CPUPlace()))
        fluid.Float16Transpiler().transpile(
            prog, scope=scope, dtype='bfloat16', feeded_var_names=feeds,
            fetch_var_names=fetches)
    return prog, feeds, fetches, scope


def test_transpiled_model_account_is_what_eviction_moves_like_jax(
        model_dirs):
    """A bf16-transpiled model beside an f32 one, under a budget that holds
    either but not both (the card's H2 form): the account of each model is
    the bytes its program reads, the same before its first eviction and
    after every reload, so every switch evicts, with the JAX registry's
    counts and accounts.  The f32 originals the transpiler leaves in the
    scope are not the model's: they are neither counted nor moved."""
    res = {}
    q = _requests(8, [4])[0]
    for pkg, (fluid, serving) in PACKAGES.items():
        reg = _registry(pkg, config=serving.ServingConfig(
            max_batch_size=4, bucket_sizes=[4]))
        prog, feeds, fetches, scope = _half_model(pkg, model_dirs['mA'])
        reg.load('half', program=prog, feed_names=feeds, fetch_list=fetches,
                 scope=scope)
        reg.load('f32', model_dirs['mB'])
        names = ['half', 'f32']
        with reg:
            resident = {n: reg.infer(n, q, timeout=30)[0] for n in names}
            for n in names:
                reg._ensure_resident(n)
            live = {n: s['hbm_bytes']
                    for n, s in reg.status()['models'].items()}
            reg.arbiter.set_budget(max(live.values()) +
                                   min(live.values()) // 2)
            outs, accounts = [], []
            for i in range(6):
                name = names[(i + 1) % 2]
                out = reg.infer(name, q, timeout=30)[0]
                if pkg == 'torch':
                    assert np.array_equal(out, resident[name]), (i, name)
                outs.append(out)
                accounts.append(reg.status()['models'][name]['hbm_bytes'])
            m = reg.metrics()
        res[pkg] = (_reg_counts(m), live, accounts, outs)
        if pkg == 'torch':
            eng = reg._entry('half').engine
            originals = [n for n in scope.local_var_names()
                         if not n.endswith('.fp16') and
                         n not in eng._model_vars]
            assert originals, 'the transpiler kept no f32 original'
            moved, _ = eng.evict_to_host()
            assert moved == live['half'] and eng.device_footprint() == 0
            for n in originals:
                assert isinstance(scope.find_var(n).value(), torch.Tensor), n
        reg.stop()
    counts, live, accounts, outs = res['torch']
    assert (counts, live, accounts) == res['jax'][:3]
    assert counts['evictions'] == 6 and counts['reloads'] == 5
    assert accounts == [live[('half', 'f32')[(i + 1) % 2]] for i in range(6)]
    for i, (a, b) in enumerate(zip(res['jax'][3], outs)):
        np.testing.assert_allclose(b, a, err_msg=str(i), **MLP_TOL)


def test_evicted_scope_holds_host_copies_bitwise(model_dirs):
    eng = tserving.InferenceEngine.from_saved_model(
        model_dirs['mB'], place=tfluid.CPUPlace())
    eng.infer(_requests(3, [2])[0])
    before = {n: eng._scope.find_var(n).value().clone()
              for n in eng._scope.local_var_names()}
    eng.evict_to_host()
    for n, v in before.items():
        held = eng._scope.find_var(n).value()
        assert isinstance(held, tfluid.core.LoDTensor), n
        assert held.tensor().dtype == v.dtype
        assert torch.equal(held.tensor(), v), n
    assert eng._exe.cached_blocks() == [] and eng._exe._retired == []


def test_admission_reject_typed_like_jax(model_dirs):
    counts = {}
    for pkg, (fluid, serving) in PACKAGES.items():
        reg = _registry(pkg, hbm_budget_bytes=64)
        with pytest.raises(serving.HBMBudgetError) as ei:
            reg.load('big', model_dirs['mA'])
        assert ei.value.model == 'big'
        assert ei.value.need_bytes > ei.value.budget_bytes == 64
        assert reg.models() == []
        counts[pkg] = (reg.metrics()['admission_rejects'],
                       ei.value.need_bytes)
        reg2 = _registry(pkg)
        reg2.load('m', model_dirs['mA'])
        with pytest.raises(ValueError, match='already loaded'):
            reg2.load('m', model_dirs['mB'])
        reg2.unload('m')
        with pytest.raises(KeyError):
            reg2.unload('m')
        for bad in ('a:b', 'a/b', ''):
            with pytest.raises(ValueError):
                reg2.load(bad, model_dirs['mA'])
        reg.stop()
        reg2.stop()
    assert counts['torch'] == counts['jax']


def test_budget_accounting_matches_live_buffer_stats(model_dirs):
    """Once a model serves, its account moves from the seed to the live
    bytes of its scope's tensors, as in the JAX registry."""
    res = {}
    for pkg in PACKAGES:
        reg = _registry(pkg)
        eng = reg.load('m', model_dirs['mB'])
        st0 = reg.status()['models']['m']
        assert st0['account_source'] == 'seed'
        assert st0['device_footprint'] == 0
        reg.infer('m', _requests(3, [4])[0], timeout=30)
        reg._ensure_resident('m')
        st = reg.status()['models']['m']
        assert st['account_source'] == 'live'
        assert st['hbm_bytes'] == st['device_footprint'] > 0
        res[pkg] = (st0['hbm_bytes'], st['hbm_bytes'])
        reg.stop()
    assert res['torch'] == res['jax']
    eng_bytes = sum(v.numel() * v.element_size() for v in (
        eng._scope.find_var(n).value() for n in eng._scope.local_var_names())
        if isinstance(v, torch.Tensor))
    assert eng_bytes == res['torch'][1]


def test_registry_audit_on_the_cpu(model_dirs):
    reg = _registry('torch')
    reg.load('m', model_dirs['mA'])
    reg.infer('m', _requests(4, [2])[0], timeout=30)
    reg._ensure_resident('m')
    audit = reg.audit()
    assert audit['drift_bytes'] == 0 and audit['live_bytes'] > 0
    assert reg.metrics()['audit']['live_bytes'] == audit['live_bytes']
    reg.stop()


def test_warm_precompiles_the_bucket_ladder_like_jax(model_dirs):
    """warm() runs one zero request per rung; traffic inside the ladder
    then plans nothing more, with the JAX registry's compile counts."""
    res = {}
    for pkg, (fluid, serving) in PACKAGES.items():
        reg = _registry(pkg, config=serving.ServingConfig(
            max_batch_size=8, bucket_sizes=[4, 8]))
        reg.load('m', model_dirs['mC'])
        assert reg.warm('m') == 2
        compiles = reg.metrics()['models']['m']['compiles']
        for r in _requests(4, [3, 4, 7, 8]):
            reg.infer('m', r, timeout=30)
        after = reg.metrics()['models']['m']['compiles']
        assert after == compiles
        with pytest.raises(ValueError, match='not feeds'):
            reg.warm('m', trailing={'nope': [8]})
        res[pkg] = (compiles, after)
        reg.stop()
    assert res['torch'] == res['jax']


def test_registry_overload_admission_typed_like_jax(model_dirs):
    """Past its queue-depth watermark the registry refuses at the door
    with OverloadedError and a retry hint; the held requests still serve;
    the counters are the JAX registry's.  A paused engine's worker may
    still take a flushed lot off the queue (it waits outside the pause),
    so the flush window is wide enough that the two held requests are
    still queued when the third arrives."""
    res = {}
    for pkg, (fluid, serving) in PACKAGES.items():
        reg = _registry(pkg, config=serving.ServingConfig(
            max_batch_size=8, max_wait_ms=500, bucket_sizes=[8],
            admit_queue_depth=2, admit_queue_age_ms=60000))
        reg.load('m', model_dirs['mA'])
        reqs = _requests(6, [2, 2, 2, 2, 2])
        with reg:
            reg.infer('m', reqs[0], timeout=30)
            eng = reg._entry('m').engine
            with eng.paused():
                held = [reg.submit('m', r) for r in reqs[1:3]]
                with pytest.raises(serving.OverloadedError) as ei:
                    reg.submit('m', reqs[3])
                assert ei.value.queue_depth >= 2
                assert ei.value.retry_after_s > 0
            outs = [f.result(30)[0] for f in held]
            reg.infer('m', reqs[4], timeout=30)
            m = reg.metrics()
        res[pkg] = (outs, m['overload_rejects'],
                    m['models']['m']['router']['overload_rejects'],
                    m['admission_rejects'])
        reg.stop()
    assert res['torch'][1:] == res['jax'][1:] == (1, 1, 0)
    for a, b in zip(res['jax'][0], res['torch'][0]):
        np.testing.assert_allclose(b, a, **MLP_TOL)


def test_lifecycle_is_thread_safe_against_in_flight_requests(model_dirs):
    """load/unload racing concurrent request streams under a forcing
    budget: every future resolves to its model's value (BATCH_TOL: two
    clients' requests may share a lot), and no worker dies."""
    seed = program_seed_bytes(tserving.InferenceEngine.from_saved_model(
        model_dirs['mA'], place=tfluid.CPUPlace())._program, 32)
    reg = _registry('torch', hbm_budget_bytes=int(2.5 * seed))
    reg.load('mA', model_dirs['mA'])
    reg.load('mB', model_dirs['mB'])
    reqs = _requests(5, [2] * 6)
    refs = {n: _standalone('torch', model_dirs[n], reqs)
            for n in ('mA', 'mB')}
    errors = []

    def client(model):
        try:
            for j, q in enumerate(reqs):
                out, = reg.infer(model, q, timeout=30)
                # two clients of a model may share a lot: a 4-row GEMM
                np.testing.assert_allclose(out, refs[model][j],
                                           err_msg=model, **BATCH_TOL)
        except Exception as e:
            errors.append(repr(e))

    def churner():
        try:
            for i in range(2):
                reg.load('mC', model_dirs['mC'])
                reg.infer('mC', reqs[i], timeout=30)
                reg.unload('mC')
        except Exception as e:
            errors.append(repr(e))

    with reg:
        threads = [threading.Thread(target=client, args=(m, ))
                   for m in ('mA', 'mB') for _ in range(2)]
        threads.append(threading.Thread(target=churner))
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    m = reg.metrics()
    assert all(m['models'][n]['errors'] == 0 for n in m['models'])
    assert m['evictions'] >= 1
    reg.stop()


def test_unload_vs_submit_typed_never_hangs(model_dirs):
    reg = _registry('torch')
    reg.load('m', model_dirs['mA'])
    r = _requests(7, [2])[0]
    with reg:
        fut = reg.submit('m', r)
        reg.unload('m')
        assert np.isfinite(fut.result(30)[0]).all()
        with pytest.raises(KeyError):
            reg.submit('m', r)
    eng = tserving.InferenceEngine.from_saved_model(
        model_dirs['mA'], place=tfluid.CPUPlace())
    eng.stop()
    with pytest.raises(tserving.EngineClosedError):
        eng.submit(r)
    reg.stop()


def test_concurrent_engines_share_one_executor(model_dirs):
    """Two engines over ONE executor, hammered from more threads than the
    machine has cores with a short switch interval: the cache lock keeps
    concurrent resolves consistent; every future resolves to its own
    model's value, and the engines count every request."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    engines, refs = {}, {}
    reqs = _requests(6, [1 + (i % 4) for i in range(8)])
    for name in ('mA', 'mB'):
        scope = tfluid.core.Scope()
        with tfluid.scope_guard(scope):
            prog, feeds, fetches = tfluid.io.load_inference_model(
                model_dirs[name], exe)
        engines[name] = tserving.InferenceEngine(
            prog, feed_names=feeds, fetch_list=fetches, scope=scope,
            executor=exe, name='shared-' + name)
        refs[name] = [engines[name].infer(q)[0] for q in reqs]
    errors = []

    def client(name):
        try:
            for j, q in enumerate(reqs):
                out, = engines[name].infer(q, timeout=30)
                # concurrent inline callers may share a lot
                np.testing.assert_allclose(out, refs[name][j],
                                           err_msg=name, **BATCH_TOL)
        except Exception as e:
            errors.append(repr(e))

    n_threads = os.cpu_count() + 2
    threads = [threading.Thread(target=client, args=(n, ))
               for n in ('mA', 'mB') for _ in range(n_threads // 2 + 1)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    per_model = len(reqs) * (1 + len(threads) // 2)
    assert all(eng.metrics()['requests'] == per_model
               for eng in engines.values())
    # dropping one model's blocks leaves the other's in the shared cache
    n_before = len(exe.cached_blocks())
    dropped = engines['mA'].drop_executables()
    assert 0 < dropped < n_before
    assert all(b.program is not engines['mA']._program
               for b in exe.cached_blocks())


# ---- the Transformer in the registry -----------------------------------

@pytest.fixture(scope='module')
def transformer_models():
    """Two Transformers at n_layer=2 (startup seeds 1 and 2) in both
    packages, the port's scopes holding every persistable of the JAX
    package's startup (parameters and Adam's accumulators, which the
    scopes' live bytes count)."""
    out = {'jax': {}, 'torch': {}}
    for name, seed in (('tA', 1), ('tB', 2)):
        with jax_unique_name.guard():
            jm = jax_transformer.build(**SMALL_TF)
        with tfluid.unique_name.guard():
            tm = torch_transformer.build(**SMALL_TF)
        jm['startup'].random_seed = seed
        jscope = jfluid.core.Scope()
        jfluid.Executor(jfluid.CPUPlace()).run(jm['startup'], scope=jscope)
        arrays = {v.name: np.asarray(jscope.find_var(v.name).value())
                  for v in jm['main'].list_vars() if v.persistable}
        tscope = tfluid.core.Scope()
        tfluid.persistables_from_numpy(tm['main'], arrays, scope=tscope,
                                       place=tfluid.CPUPlace())
        out['jax'][name] = (jm, jscope)
        out['torch'][name] = (tm, tscope)
    return out


def _tf_feed(seed, rows=4, length=16):
    rng = np.random.RandomState(seed)
    return {n: rng.randint(1, SMALL_TF['trg_vocab'],
                           size=(rows, length)).astype('int64')
            for n in ('src_ids', 'trg_ids', 'lbl_ids')}


def test_transformer_registry_evicts_and_reloads_like_jax(
        transformer_models):
    """Two Transformers loaded unbudgeted and served once each; then the
    budget drops to 1.5x one model's live bytes (the card's H2 form) and
    alternating requests evict and reload: the JAX registry's counts and
    accounts, its fetches within 1e-4, and in the port each response after
    a reload bitwise equal to the resident one.

    The port's scopes hold Adam's accumulators on the device, which the
    test program does not read: the port's account is the program's reads
    from the first serve on, and every switch evicts.  The JAX registry is
    handed its scopes in host form, as its ``load_inference_model`` gives
    them: with device-resident unread state its account would count that
    state until the first eviction and never stage it back, so it would
    shrink after a reload and the budget stop evicting."""
    res = {}
    feeds = [_tf_feed(s) for s in range(3)]
    for pkg, (fluid, serving) in PACKAGES.items():
        reg = _registry(pkg, config=serving.ServingConfig(
            max_batch_size=4, bucket_sizes=[4]))
        for name, (m, scope) in transformer_models[pkg].items():
            if pkg == 'jax':
                host = fluid.core.Scope()
                for n in scope.local_var_names():
                    host.var(n).set_value(np.asarray(
                        scope.find_var(n).value()))
                scope = host
            reg.load(name, program=m['test'], feed_names=m['feeds'],
                     fetch_list=[m['prediction']], scope=scope)
        with reg:
            resident = {n: reg.infer(n, feeds[0], timeout=30)[0]
                        for n in ('tA', 'tB')}
            for n in ('tA', 'tB'):
                reg._ensure_resident(n)
            live = max(s['hbm_bytes']
                       for s in reg.status()['models'].values())
            reg.arbiter.set_budget(int(1.5 * live))
            outs, accounts = [], []
            for i in range(4):
                name = ('tA', 'tB')[i % 2]
                out = reg.infer(name, feeds[0], timeout=30)[0]
                if pkg == 'torch':
                    assert np.array_equal(out, resident[name]), (i, name)
                outs.append(out)
                accounts.append(reg.status()['models'][name]['hbm_bytes'])
            outs.append(reg.infer('tB', feeds[1], timeout=30)[0])
            m = reg.metrics()
        res[pkg] = (outs, _reg_counts(m), live, accounts)
        reg.stop()
    _, counts, live, accounts = res['torch']
    assert (counts, live, accounts) == res['jax'][1:]
    assert accounts == [live] * 4
    assert counts['evictions'] >= 3 and counts['reloads'] >= 3
    for a, b in zip(res['jax'][0], res['torch'][0]):
        np.testing.assert_allclose(b, a, **TF_TOL)


# ---- PaddlePredictor and Inferencer ------------------------------------

def test_predictor_matches_jax_and_clones(model_dirs):
    """create_paddle_predictor(NativeConfig(use_gpu=False)) on the MLP:
    list and dict inputs, the clone sharing the weights, as the JAX
    package's predictor; NativeConfig's default is the card."""
    x = _requests(8, [3])[0]['img']
    outs = {}
    for pkg, mod in (('jax', jinference), ('torch', tinference)):
        kw = {'use_tpu': False} if pkg == 'jax' else {'use_gpu': False}
        pred = mod.create_paddle_predictor(
            mod.NativeConfig(model_dir=model_dirs['mA'], **kw))
        assert pred.feed_names == ['img']
        a = pred.run([mod.PaddleTensor(data=x)])
        b = pred.clone().run({'img': x})
        assert a[0].name == pred.fetch_names[0] and a[0].shape == [3, 10]
        np.testing.assert_allclose(b[0].data, a[0].data, rtol=0, atol=0)
        outs[pkg] = a[0].data
    np.testing.assert_allclose(outs['torch'], outs['jax'], **MLP_TOL)
    assert tinference.NativeConfig().use_gpu is True
    assert tinference.NativeConfig(use_tpu=False).use_gpu is False


def test_predictor_serves_lod_and_the_transformer_like_jax(
        tmp_path, transformer_models):
    """LoD PaddleTensors (the stacked LSTM's feed form) through a saved
    sequence model, the port's predictor against the JAX package's; the
    Transformer, whose programs neither package serializes, is refused
    by both at save_inference_model (it serves through the engine and
    the registry instead)."""
    # a sequence model saved by the JAX package
    d = str(tmp_path / 'seq')
    prog, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = 4
    with jfluid.program_guard(prog, startup):
        ids = jfluid.layers.data('words', shape=[1], dtype='int64',
                                 lod_level=1)
        emb = jfluid.layers.embedding(ids, size=[60, 16])
        fc = jfluid.layers.fc(emb, 4 * 8)
        lstm, _ = jfluid.layers.dynamic_lstm(fc, size=4 * 8,
                                             use_peepholes=False)
        pooled = jfluid.layers.sequence_pool(lstm, pool_type='max')
        pred = jfluid.layers.fc(pooled, 2, act='softmax')
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(d, ['words'], [pred], exe,
                                       main_program=prog)
    rng = np.random.RandomState(9)
    lengths = [5, 2, 9]
    flat = rng.randint(0, 60, size=(sum(lengths), 1)).astype('int64')
    offsets = list(np.cumsum([0] + lengths))
    outs = {}
    for pkg, mod in (('jax', jinference), ('torch', tinference)):
        kw = {'use_tpu': False} if pkg == 'jax' else {'use_gpu': False}
        p = mod.create_paddle_predictor(mod.NativeConfig(model_dir=d, **kw))
        outs[pkg] = p.run([mod.PaddleTensor(name='words', data=flat,
                                            lod=[offsets])])[0].data
    assert outs['torch'].shape == (3, 2)
    np.testing.assert_allclose(outs['torch'], outs['jax'], **MLP_TOL)
    # the Transformer's programs do not serialize in either package (its
    # nested-list assign_value attr; ROADMAP Queue 3, shared with the
    # reference): both refuse its inference model alike
    for pkg in PACKAGES:
        fluid = PACKAGES[pkg][0]
        m, scope = transformer_models[pkg]['tA']
        with fluid.scope_guard(scope), pytest.raises(TypeError):
            fluid.io.save_inference_model(
                str(tmp_path / ('tf_' + pkg)), m['feeds'],
                [m['prediction']], fluid.Executor(fluid.CPUPlace()),
                main_program=m['test'])


def _param_dir(fluid, tmpdir):
    prog, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.program_guard(prog, startup):
        with fluid.unique_name.guard():
            a = fluid.layers.data('a', [4])
            b = fluid.layers.data('b', [4])
            fluid.layers.fc(a, 2, name='srv_fc_a')
            fluid.layers.fc(b, 2, name='srv_fc_b')
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.core.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_persistables(exe, tmpdir, main_program=prog)


def test_inferencer_rides_the_engine_like_jax(tmp_path):
    """fluid.Inferencer serves through the engine's inline mode: feeds
    that disagree on rows raise, agreeing ones serve, as the JAX
    package's Inferencer does (the port reads the JAX package's saved
    persistables); with parallel=True it evaluates on a
    ParallelExecutor."""
    pdir = str(tmp_path)
    _param_dir(jfluid, pdir)
    outs = {}
    for pkg, (fluid, _) in PACKAGES.items():
        def infer_func(fluid=fluid):
            a = fluid.layers.data('a', [4])
            b = fluid.layers.data('b', [4])
            fa = fluid.layers.fc(a, 2, name='srv_fc_a')
            fb = fluid.layers.fc(b, 2, name='srv_fc_b')
            return fluid.layers.elementwise_add(fa, fb)

        inf = fluid.Inferencer(infer_func=infer_func, param_path=pdir,
                               place=fluid.CPUPlace())
        with pytest.raises(ValueError, match='leading'):
            inf.infer({'a': np.zeros((3, 4), 'float32'),
                       'b': np.zeros((2, 4), 'float32')})
        rng = np.random.RandomState(1)
        out = inf.infer({'a': rng.rand(3, 4).astype('float32'),
                         'b': rng.rand(3, 4).astype('float32')})
        assert out[0].shape == (3, 2)
        assert inf._engine.metrics()['requests'] == 1
        outs[pkg] = out[0]
    np.testing.assert_allclose(outs['torch'], outs['jax'], **MLP_TOL)
    # parallel=True evaluates on a ParallelExecutor (one rank here): the
    # same predictions
    inf = tfluid.Inferencer(infer_func=infer_func, param_path=pdir,
                            place=tfluid.CPUPlace(), parallel=True)
    rng = np.random.RandomState(1)
    out = inf.infer({'a': rng.rand(3, 4).astype('float32'),
                     'b': rng.rand(3, 4).astype('float32')})
    np.testing.assert_array_equal(out[0], outs['torch'])


@pytest.mark.parametrize('entry', ['registry', 'inferencer', 'predictor'])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path,
                                          model_dirs):
    """Without a place each entry point runs on CUDAPlace(0), which needs
    a card; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        if entry == 'registry':
            reg = tserving.ModelRegistry()
            assert reg.place == tfluid.CUDAPlace(0)
            reg.load('m', model_dirs['mA'])
        elif entry == 'predictor':
            tinference.create_paddle_predictor(
                tinference.NativeConfig(model_dir=model_dirs['mA']))
        else:
            tfluid.Inferencer(infer_func=lambda: None,
                              param_path=str(tmp_path))


@pytest.mark.parametrize('cut', ['parallel', 'mesh', 'embed_caches'])
def test_registry_cut_features_raise(cut, model_dirs):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        if cut in ('parallel', 'mesh'):
            tserving.ModelRegistry(place=tfluid.CPUPlace(),
                                   **{cut: {'dp': 2}})
        reg = _registry('torch')
        reg.load('m', model_dirs['mA'], embed_caches=[object()])


# ---- the executor: dropped, closed, purged ------------------------------

def _one_block_program():
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        x = tfluid.layers.data('x', [3])
        y = tfluid.layers.fc(x, 2)
    scope = tfluid.core.Scope()
    return prog, startup, y, scope


def test_dropped_executor_is_freed_without_cyclic_collection():
    """An executor that ran a program is freed as soon as it is dropped,
    while the program and the scope live on: its cache's finalizers hold
    it weakly (no gc.collect() runs)."""
    prog, startup, y, scope = _one_block_program()
    gc.disable()
    try:
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        exe.run(prog, feed={'x': np.ones((2, 3), 'float32')},
                fetch_list=[y], scope=scope)
        blocks = [weakref.ref(b) for b in exe.cached_blocks()]
        ref = weakref.ref(exe)
        del exe
        assert ref() is None
        assert all(b() is None for b in blocks)
    finally:
        gc.enable()
    assert prog.global_block() is not None and scope is not None


def test_dropped_engine_frees_its_executor_without_cyclic_collection(
        model_dirs):
    """A started engine (its watchdog probe registered) that served queued
    windows and was stopped is freed with its executor and their blocks as
    soon as it is dropped, no gc.collect() run: the CPU form of path H1's
    check on the card."""
    eng = tserving.InferenceEngine.from_saved_model(
        model_dirs['mA'], place=tfluid.CPUPlace(), name='gc-free',
        config=tserving.ServingConfig(max_batch_size=8, bucket_sizes=[8],
                                      watchdog_stall_s=30))
    eng.start()
    for _ in range(2):
        with eng.paused():
            futs = [eng.submit(r) for r in _requests(9, [2, 3, 1])]
        assert all(np.isfinite(f.result(30)[0]).all() for f in futs)
    eng.stop()
    assert eng.metrics()['lots'] < eng.metrics()['requests']
    gc.collect()
    gc.disable()
    try:
        refs = [weakref.ref(eng), weakref.ref(eng._exe)] + [
            weakref.ref(b) for b in eng._exe.cached_blocks()]
        assert len(refs) > 2
        del eng, futs
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_close_releases_every_block_and_purge_keeps_others():
    prog, startup, y, scope = _one_block_program()
    other, _, y2, _ = _one_block_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {'x': np.ones((2, 3), 'float32')}
    exe.run(prog, feed=feed, fetch_list=[y], scope=scope)
    c = exe.compile_count
    assert exe.purge_programs([other]) == 0
    assert exe.purge_programs([prog]) == 1
    assert len(exe._retired) == 1
    assert [b.program for b in exe.cached_blocks()] == [startup]
    exe.run(prog, feed=feed, fetch_list=[y], scope=scope)
    assert exe.compile_count == c + 1 and exe._retired == []
    exe.close()
    assert exe.cached_blocks() == [] and exe._retired == [] \
        and exe._finalizers == {}
    with pytest.raises(RuntimeError, match='closed'):
        exe.run(prog, feed=feed, fetch_list=[y], scope=scope)
