"""The PyTorch port's serving engine held against the JAX package's on the
CPU (``CPUPlace()``): the same requests, made from a numpy seed, go to
``paddle_tpu.serving.InferenceEngine`` and to
``paddle_tpu_torch.serving.InferenceEngine``, and the fetches and the
counts (requests, lots, dispatches, compiles, the executor's compile
count, bucket and trailing hits, padding waste) are held equal.  Each case
mirrors one of ``tests/test_serving.py``, ``test_trailing_buckets.py`` or
``test_slo_serving.py`` (the mesh ones excepted).

Request streams run in two modes.  Deferred inline: the requests queue in
a never-started engine and one synchronous drain coalesces them, the same
way in both packages, so the lot and dispatch counts are deterministic.
Queued: a started engine's worker; the futures are waited on with a
timeout of their own, and nothing sleeps to synchronise.

Tolerances: the MNIST MLP's softmax 1e-5 (rtol, atol 1e-6), the same f32
arithmetic up to summation order as ``test_torch_mnist``; the Transformer
at n_layer=2 1e-4 (rtol and atol), as ``test_torch_transformer`` states.
Within the port on the CPU, a batched and bucketed result is held to the
port's own unbatched ``exe.run`` bitwise where the model's products are
narrow (the sequence model, the host-op program), and within rtol 2e-6 for
the MNIST MLP (``BATCH_TOL``): torch's CPU GEMM picks its kernel by the row
count (one row runs a GEMV), so a row computed in an 8-row lot differs from
the same row alone in the last bits (measured: at most 5e-7 relative).
The JAX package's tests hold this bitwise; the port cannot on 784-wide
rows.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.models import mnist as jax_mnist
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import transformer as torch_transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP_TOL = dict(rtol=1e-5, atol=1e-6)
TF_TOL = dict(rtol=1e-4, atol=1e-4)
BATCH_TOL = dict(rtol=2e-6, atol=0)
COUNTS = ('requests', 'rows', 'lots', 'dispatches', 'compiles',
          'executor_compile_count', 'full_flushes', 'deadline_flushes',
          'trailing_padding_waste', 'shed', 'errors')
PACKAGES = {'jax': (jfluid, jserving), 'torch': (tfluid, tserving)}



@pytest.fixture(autouse=True)
def _own_names():
    """Each case names its vars afresh in both packages and leaves the
    global name counters as it found them: other files build programs in
    both packages unguarded and compare the names."""
    with jax_unique_name.guard(), tfluid.unique_name.guard():
        yield

# ---- models and request streams ----------------------------------------

@pytest.fixture(scope='module')
def mlp_dir(tmp_path_factory):
    """The MNIST MLP's test program saved by the JAX package: both
    packages load the same inference model."""
    d = str(tmp_path_factory.mktemp('mnist_mlp'))
    with jax_unique_name.guard():
        m = jax_mnist.build(nn_type='mlp')
    m['test'].random_seed = 3
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.core.Scope()
    with jfluid.scope_guard(scope):
        exe.run(m['startup'])
        jfluid.io.save_inference_model(d, ['img'], [m['prediction']], exe,
                                       main_program=m['test'])
    return d


def _mlp_engine(pkg, d, **cfg):
    fluid, serving = PACKAGES[pkg]
    return serving.InferenceEngine.from_saved_model(
        d, place=fluid.CPUPlace(), config=serving.ServingConfig(**cfg))


def _engine_counts(eng, c0):
    """``_counts`` of a live engine, its executor's compile count taken
    from ``c0``."""
    return _counts(eng.metrics(), c0)


def _mlp_requests(seed, sizes):
    rng = np.random.RandomState(seed)
    return [{'img': rng.rand(n, 784).astype('float32')} for n in sizes]


def _deferred(eng, reqs, **kw):
    """Queue ``reqs`` in a never-started engine, then drain them in one
    synchronous pass: the lots form from the whole queue, the same way in
    both packages.  Returns the results and the engine's metrics, its
    executor's compile count taken from the start of the stream (the
    packages' set-up runs count differently: the JAX package's
    load_inference_model and startup runs go through the executor)."""
    c0 = eng._exe.compile_count
    eng._drain_inline = lambda: None
    futs = [eng.submit(r, **kw) for r in reqs]
    del eng._drain_inline
    eng._drain_inline()
    outs = [f.result(30) for f in futs]
    m = eng.metrics()
    m['executor_compile_count'] -= c0
    return outs, m


def _counts(m, c0=0):
    out = {k: m[k] for k in COUNTS}
    out['executor_compile_count'] -= c0
    out['buckets'] = (m['buckets']['active'], m['buckets']['hits'])
    tb = m['trailing_buckets']
    out['trailing'] = tb and (tb['hits'], tb['oversized'])
    return out


def _assert_same(outs_j, outs_t, tol):
    assert len(outs_j) == len(outs_t)
    for i, (oj, ot) in enumerate(zip(outs_j, outs_t)):
        for a, b in zip(oj, ot):
            assert np.shape(b) == np.shape(a), i
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       err_msg='request %d' % i, **tol)


SMALL_TF = dict(src_vocab=100, trg_vocab=100, max_len=16, n_layer=2,
                n_head=4, d_model=64, d_ff=128)


@pytest.fixture(scope='module')
def transformer_pair():
    """The Transformer at n_layer=2 in both packages, the port's scope
    holding the JAX package's startup parameters."""
    with jax_unique_name.guard():
        jm = jax_transformer.build(**SMALL_TF)
    with tfluid.unique_name.guard():
        tm = torch_transformer.build(**SMALL_TF)
    jscope = jfluid.core.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jm['startup'], scope=jscope)
    arrays = {p.name: np.asarray(jscope.find_var(p.name).value())
              for p in jm['test'].all_parameters()}
    tscope = tfluid.core.Scope()
    tfluid.params_from_numpy(tm['test'], arrays, scope=tscope,
                             place=tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    return {'jax': (jm, jscope, jexe), 'torch': (tm, tscope, texe)}


def _tf_requests(seed, lengths, rows=4):
    rng = np.random.RandomState(seed)
    return [{n: rng.randint(1, SMALL_TF['trg_vocab'],
                            size=(rows, l)).astype('int64')
             for n in ('src_ids', 'trg_ids', 'lbl_ids')} for l in lengths]


def _tf_engine(pair, pkg, **cfg):
    fluid, serving = PACKAGES[pkg]
    m, scope, _ = pair[pkg]
    return serving.InferenceEngine(
        m['test'], feed_names=m['feeds'], fetch_list=[m['prediction']],
        scope=scope, executor=fluid.Executor(fluid.CPUPlace()),
        place=fluid.CPUPlace(),
        config=serving.ServingConfig(**cfg))


def _seq_model(fluid, seed=3):
    """Embedding + masked sum-pool + fc (``test_trailing_buckets``'s
    model): per-row outputs depend only on the real positions."""
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data('ids', shape=[1], dtype='int64', lod_level=1)
        emb = fluid.layers.embedding(
            x, size=[50, 8], param_attr=fluid.ParamAttr(name='seq_emb'))
        pooled = fluid.layers.sequence_pool(emb, pool_type='sum')
        pred = fluid.layers.fc(pooled, 4, act='softmax',
                               param_attr=fluid.ParamAttr(name='seq_fc_w'),
                               bias_attr=fluid.ParamAttr(name='seq_fc_b'))
    return prog.clone(for_test=True), startup, pred


@pytest.fixture(scope='module')
def seq_pair():
    out = {}
    jprog, jstart, jpred = _seq_model(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.core.Scope()
    jexe.run(jstart, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n).value())
              for n in ('seq_emb', 'seq_fc_w', 'seq_fc_b')}
    out['jax'] = (jprog, jpred, jexe, jscope)
    tprog, _, tpred = _seq_model(tfluid)
    tscope = tfluid.core.Scope()
    tfluid.params_from_numpy(tprog, arrays, scope=tscope,
                             place=tfluid.CPUPlace())
    out['torch'] = (tprog, tpred, tfluid.Executor(tfluid.CPUPlace()),
                    tscope)
    return out


def _seq_engine(pair, pkg, **cfg):
    """An engine over the pair's scope with an executor of its own, so
    that the blocks other cases cached never reach its counts."""
    fluid, serving = PACKAGES[pkg]
    prog, pred, _, scope = pair[pkg]
    return serving.InferenceEngine(
        prog, feed_names=['ids'], fetch_list=[pred], scope=scope,
        executor=fluid.Executor(fluid.CPUPlace()), place=fluid.CPUPlace(),
        config=serving.ServingConfig(**cfg))


def _lod_request(fluid, rng, lens):
    rows = [rng.randint(0, 50, size=(l, 1)).tolist() for l in lens]
    return {'ids': fluid.create_lod_tensor(rows, [list(lens)])}


SEQ_LENS = ([3, 7], [12, 2, 5], [9], [30, 4], [14], [27, 20])


# ---- buckets, batcher, profile: the host-side units --------------------

def test_bucket_set_policy_matches_jax():
    for args, kw, rows in (((32, ), {}, (3, 32, 40, 1, 17)),
                           ((32, ), {'sizes': [8, 16]}, (17, 3, 9)),
                           ((64, ), {'sizes': [1, 2, 4, 8, 16, 32, 64],
                                     'max_buckets': 2}, (1, 2, 4, 8, 2))):
        bj = jserving.ShapeBucketSet(*args, **kw)
        bt = tserving.ShapeBucketSet(*args, **kw)
        assert bt.sizes == bj.sizes
        assert [bt.bucket_for(r) for r in rows] == \
            [bj.bucket_for(r) for r in rows]
        assert bt.report() == bj.report()


def test_trailing_dim_buckets_match_jax():
    specs = [({}, [('x', 1, e) for e in (7, 40, 256, 257, 1000)]),
             ({'ladders': {'img': {2: [224, 256], 3: [224, 256]},
                           'x': [8, 16]}},
              [('img', 2, 200), ('x', 1, 9), ('x', 1, 40), ('img', 3, 256)]),
             ({'max_buckets': 2}, [('x', 1, e) for e in (5, 20, 40, 70)])]
    for kw, calls in specs:
        tj = jserving.TrailingDimBuckets(**kw)
        tt = tserving.TrailingDimBuckets(**kw)
        assert [tt.bucket_for(*c) for c in calls] == \
            [tj.bucket_for(*c) for c in calls]
        assert tt.report() == tj.report()
        for name in ('x', 'img'):
            assert tt.ladder_axes(name) == tj.ladder_axes(name)
    for bad in ({'ladders': {'img': {0: [224]}}}, {'max_buckets': 0},
                {'ladders': {'x': []}}):
        with pytest.raises(ValueError):
            jserving.TrailingDimBuckets(**bad)
        with pytest.raises(ValueError):
            tserving.TrailingDimBuckets(**bad)


def test_bucket_report_never_races_lru_eviction():
    """Hammer bucket_for from threads (constant LRU eviction) while
    report() snapshots: every snapshot is consistent, nothing raises."""
    sets = [tserving.ShapeBucketSet(1 << 14, max_buckets=3),
            tserving.TrailingDimBuckets(max_buckets=3)]
    errors, stop = [], threading.Event()

    def hammer(bs, seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(300):
                ext = int(rng.randint(1, 1 << 12))
                if isinstance(bs, tserving.TrailingDimBuckets):
                    bs.bucket_for('f%d' % (ext % 5), 1, ext)
                else:
                    bs.bucket_for(ext)
        except Exception as e:
            errors.append(repr(e))

    def snapshot(bs):
        try:
            while not stop.is_set():
                rep = bs.report()
                assert sorted(rep['active']) == sorted(rep['hits']), rep
        except Exception as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=hammer, args=(bs, i))
               for i, bs in enumerate(sets) for _ in range(3)]
    snappers = [threading.Thread(target=snapshot, args=(bs, ))
                for bs in sets]
    for t in threads + snappers:
        t.start()
    for t in threads:
        t.join(30)
    stop.set()
    for t in snappers:
        t.join(30)
    assert not any(t.is_alive() for t in threads + snappers)
    assert not errors, errors
    assert all(len(bs.report()['active']) <= 3 for bs in sets)


def _batch_order(serving, specs, **kw):
    """The lots a MicroBatcher forms from requests given as (rows, sig,
    priority, deadline_ms) and the requests it shed, by index."""
    shed = []
    mb = serving.MicroBatcher(max_batch_size=kw.pop('max_batch_size', 4),
                              max_wait_s=0.0, on_shed=shed.append, **kw)
    reqs = []
    t0 = time.time()
    for i, (rows, sig, prio, dl) in enumerate(specs):
        r = serving.InferenceRequest({'x': i}, rows, sig, priority=prio,
                                     deadline_ms=dl)
        r.enqueue_t = t0 + i * 1e-3  # arrival order, whatever the clock
        if dl is not None:
            r.deadline_t = r.enqueue_t + dl / 1e3
        reqs.append(mb.submit(r))
    lots = []
    while True:
        lot = mb.next_lot(timeout=0, force=True)
        if not lot:
            break
        lots.append([reqs.index(r) for r in lot])
    return lots, sorted(reqs.index(r) for r in shed)


BATCH_STREAMS = {
    'fifo_plain': ([(1, 'a', 0, None)] * 6, {}),
    'priority_then_deadline': (
        [(1, 'a', 0, None), (1, 'a', 2, 5e4), (1, 'a', 2, 1e4),
         (1, 'a', 1, None), (2, 'b', 3, None), (1, 'a', 0, 2e4)], {}),
    'fifo_mode_keeps_order': (
        [(1, 'a', 0, None), (1, 'a', 5, 1e4), (3, 'a', 1, None),
         (1, 'a', 9, None)], {'scheduling': 'fifo'}),
    'sheds_expired': (
        [(1, 'a', 0, -1.0), (1, 'a', 0, 5e4), (1, 'a', 0, -5.0),
         (1, 'a', 0, None)], {}),
    'sheds_unmeetable': (
        [(1, 'a', 0, 50.0), (1, 'a', 0, 5e4), (1, 'a', 0, None)],
        {'service_estimate_fn': lambda: 1.0}),
    'shed_by_class': (
        [(1, 'a', 0, 150.0), (1, 'a', 1, 5e4), (1, 'a', 1, 5e4),
         (1, 'a', 0, 5e4)],
        {'service_estimate_fn': lambda: 0.06, 'shed_by_class': True}),
    'sig_split': ([(2, 'a', 0, None), (2, 'b', 0, None), (1, 'a', 0, None),
                   (3, 'a', 0, None)], {}),
}


@pytest.mark.parametrize('name', sorted(BATCH_STREAMS))
def test_micro_batcher_lots_and_sheds_match_jax(name):
    """Lot formation (EDF within priority, FIFO without SLO fields, the
    signature and row-budget rules) and shedding (expired, unmeetable
    within the service estimate, by class) as the JAX package's."""
    specs, kw = BATCH_STREAMS[name]
    want = _batch_order(jserving, specs, **dict(kw))
    got = _batch_order(tserving, specs, **dict(kw))
    assert got == want
    if name.startswith('sheds') or name == 'shed_by_class':
        assert want[1], 'the stream must shed something'


def test_priority_aging_promotes_like_jax():
    """With priority_aging_s a low-priority request aged past k windows
    competes as priority + k; without it, strict priority."""
    for aging in (None, 0.05):
        res = []
        for serving in (jserving, tserving):
            mb = serving.MicroBatcher(max_batch_size=1, max_wait_s=0.0,
                                      priority_aging_s=aging)
            old = serving.InferenceRequest({'x': 0}, 1, 'a', priority=0)
            old.enqueue_t -= 1.0  # 20 windows of 50 ms ago
            new = serving.InferenceRequest({'x': 1}, 1, 'a', priority=3)
            mb.submit(old)
            mb.submit(new)
            res.append(mb.next_lot(timeout=0, force=True)[0] is old)
        assert res[0] == res[1] == (aging is not None)


def test_batcher_closed_and_age_stats_like_jax():
    for serving in (jserving, tserving):
        mb = serving.MicroBatcher(max_batch_size=4, max_wait_s=1.0)
        assert mb.age_stats() is None and mb.oldest_age() is None
        mb.submit(serving.InferenceRequest({'x': 0}, 1, 'a'))
        assert mb.age_stats()['depth'] == 1 and mb.oldest_age() >= 0
        mb.close()
        with pytest.raises(serving.EngineClosedError):
            mb.submit(serving.InferenceRequest({'x': 1}, 1, 'a'))
        assert len(mb.next_lot(timeout=0)) == 1
        assert mb.next_lot(timeout=0) is None


def test_unbatchable_request_flushes_without_deadline_wait():
    mb = tserving.MicroBatcher(max_batch_size=64, max_wait_s=5.0)
    mb.submit(tserving.InferenceRequest({'x': 0}, None, object()))
    t0 = time.time()
    assert len(mb.next_lot(timeout=10)) == 1
    assert time.time() - t0 < 1.0


def test_service_profile_matches_jax():
    profs = [jserving.ServiceTimeProfile(window=3),
             tserving.ServiceTimeProfile(window=3)]
    for p in profs:
        assert p.estimate('a') is None and p.floor() is None
        p.seed('a', 0.5)
        for w in (0.9, 0.3, 0.4, 0.2, 0.6):
            p.observe('b', w)
        p.observe('a', 0.7)
    assert [p.estimate(k) for p in profs[1:] for k in 'ab'] == \
        [profs[0].estimate(k) for k in 'ab']
    assert profs[1].floor() == profs[0].floor()
    assert profs[1].snapshot() == profs[0].snapshot()


CONFIG_ERRORS = [
    dict(steps_per_dispatch=0), dict(pipeline_depth=0),
    dict(max_buckets=0), dict(max_trailing_buckets=0),
    dict(trailing_buckets=False, trailing_ladders={'x': [8]}),
    dict(scheduling='lifo'), dict(priority_aging_ms=0),
    dict(scheduling='fifo', priority_aging_ms=5),
    dict(scheduling='fifo', shed_by_class=True),
    dict(admit_queue_depth=0), dict(admit_queue_age_ms=-1),
    dict(adaptive_admission=True), dict(admit_queue_age_ms=0),
    dict(decode_slots=0), dict(decode_steps=0),
    dict(decode_pipeline_depth=0), dict(prefill_chunk=0),
]


@pytest.mark.parametrize('i', range(len(CONFIG_ERRORS)))
def test_serving_config_rejects_like_jax(i):
    kw = CONFIG_ERRORS[i]
    with pytest.raises(ValueError):
        jserving.ServingConfig(**kw)
    with pytest.raises(ValueError):
        tserving.ServingConfig(**kw)


# ---- the engine on the MNIST MLP ---------------------------------------

def test_engine_batched_stream_matches_jax(mlp_dir):
    """Requests coalesced into padded, bucketed multi-lot dispatches: the
    port's fetches match the JAX engine's, its counts equal them, and
    each result equals the port's own unbatched exe.run (BATCH_TOL)."""
    reqs = _mlp_requests(3, [3, 2, 5, 1, 4, 2, 8, 3, 7, 1])
    cfg = dict(max_batch_size=8, max_wait_ms=0, steps_per_dispatch=4)
    outs_j, mj = _deferred(_mlp_engine('jax', mlp_dir, **cfg), reqs)
    eng = _mlp_engine('torch', mlp_dir, **cfg)
    outs_t, mt = _deferred(eng, reqs)
    _assert_same(outs_j, outs_t, MLP_TOL)
    assert _counts(mt) == _counts(mj)
    assert mt['lots'] < len(reqs) and mt['dispatches'] < mt['lots']
    with tfluid.scope_guard(eng._scope):
        for r, o in zip(reqs, outs_t):
            ref, = eng._exe.run(eng._program, feed=r,
                                fetch_list=eng._fetch_list)
            np.testing.assert_allclose(o[0], ref, **BATCH_TOL)


def test_engine_queued_stream_matches_unbatched(mlp_dir):
    """The started engine (its worker thread): every future resolves to
    the unbatched run (BATCH_TOL), and requests coalesced."""
    reqs = _mlp_requests(4, [3, 2, 5, 1, 4, 2, 8, 3])
    eng = _mlp_engine('torch', mlp_dir, max_batch_size=8,
                      max_wait_ms=60000, steps_per_dispatch=4)
    with eng:
        with eng.paused():
            futs = [eng.submit(r) for r in reqs]
        assert eng.queue_depth() >= 1
    outs = [f.result(30) for f in futs]
    m = eng.metrics()
    assert m['requests'] == len(reqs) and m['lots'] < len(reqs)
    assert m['dispatches'] <= m['lots'] and m['batch_fill_ratio']
    jouts = [_mlp_engine('jax', mlp_dir).infer(r) for r in reqs]
    _assert_same(jouts, outs, MLP_TOL)
    with tfluid.scope_guard(eng._scope):
        for r, o in zip(reqs, outs):
            ref, = eng._exe.run(eng._program, feed=r,
                                fetch_list=eng._fetch_list)
            np.testing.assert_allclose(o[0], ref, **BATCH_TOL)


def test_engine_inline_mode_matches_jax(mlp_dir):
    """A never-started engine serves on the caller's thread, one lot per
    request, with the JAX engine's counts."""
    reqs = _mlp_requests(5, [3, 1, 6])
    res = {}
    for pkg in PACKAGES:
        eng = _mlp_engine(pkg, mlp_dir)
        c0 = eng._exe.compile_count
        outs = [eng.infer(r) for r in reqs]
        fut = eng.submit(reqs[0])
        assert fut.done()
        res[pkg] = (outs, _engine_counts(eng, c0))
    _assert_same(res['jax'][0], res['torch'][0], MLP_TOL)
    assert res['torch'][1] == res['jax'][1]


def test_engine_max_wait_deadline_flush(mlp_dir):
    """At low traffic a partial lot flushes when the oldest request has
    aged max_wait."""
    eng = _mlp_engine('torch', mlp_dir, max_batch_size=64, max_wait_ms=30)
    reqs = _mlp_requests(6, [2, 3])
    with eng:
        with eng.paused():
            futs = [eng.submit(r) for r in reqs]
        outs = [f.result(30) for f in futs]
    m = eng.metrics()
    assert [o[0].shape for o in outs] == [(2, 10), (3, 10)]
    assert m['lots'] == 1 and m['deadline_flushes'] == 1
    assert m['full_flushes'] == 0 and m['p50_latency_ms'] is not None


def test_engine_bucket_boundary_compile_counts_match_jax(mlp_dir):
    """Same-bucket requests reuse their block (compiles flat), crossing a
    bucket boundary is one new signature: the counts after each request
    equal the JAX engine's."""
    sizes = [3, 4, 2, 5, 7, 16, 9]
    trail = {}
    for pkg in PACKAGES:
        eng = _mlp_engine(pkg, mlp_dir, max_batch_size=16,
                          bucket_sizes=[4, 8, 16])
        c0 = eng._exe.compile_count
        seen = []
        for r in _mlp_requests(6, sizes):
            eng.infer(r)
            m = eng.metrics()
            seen.append((m['compiles'], m['executor_compile_count'] - c0))
        trail[pkg] = (seen, eng.metrics()['buckets'])
    assert trail['torch'] == trail['jax']
    assert trail['torch'][1]['active'] == [4, 8, 16]


def test_engine_warns_on_cross_request_reduced_fetch():
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        x = tfluid.layers.data('x', [6])
        pred = tfluid.layers.fc(x, 4)
        avg = tfluid.layers.mean(pred)
    test_prog = prog.clone(for_test=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.core.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(9)
    eng = tserving.InferenceEngine(
        test_prog, feed_names=['x'], fetch_list=[pred, avg], scope=scope,
        executor=exe, config=tserving.ServingConfig(max_batch_size=8,
                                                    max_wait_ms=0))
    with pytest.warns(UserWarning, match='not per-row'):
        outs, m = _deferred(eng, [{'x': rng.rand(2, 6).astype('float32')}
                                  for _ in range(3)])
    assert m['lots'] == 1
    assert all(o[0].shape == (2, 4) for o in outs)
    assert all(np.shape(o[1]) == () or np.shape(o[1])[0] != 2
               for o in outs)


def test_engine_serves_host_op_programs_eagerly_like_jax():
    """A program with a host op (``Print``) serves per request through
    exe.run, counting lots and dispatches as the JAX engine does."""
    res = {}
    for pkg, (fluid, serving) in PACKAGES.items():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            x = fluid.layers.data('x', [6])
            h = fluid.layers.fc(x, 4, param_attr=fluid.ParamAttr(
                name='eager_w', initializer=fluid.initializer.Constant(0.1)))
            fluid.layers.Print(h)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.core.Scope()
        exe.run(startup, scope=scope)
        eng = serving.InferenceEngine(prog, feed_names=['x'],
                                      fetch_list=[h], scope=scope,
                                      executor=exe, place=fluid.CPUPlace())
        r = {'x': np.random.RandomState(12).rand(3, 6).astype('float32')}
        c0 = exe.compile_count
        out, = eng.infer(r)
        res[pkg] = (out, _engine_counts(eng, c0))
        ref, = exe.run(prog, feed=r, fetch_list=[h], scope=scope)
        assert np.array_equal(out, ref)
    np.testing.assert_allclose(res['torch'][0], res['jax'][0], **MLP_TOL)
    assert res['torch'][1] == res['jax'][1]
    assert res['torch'][1]['lots'] == res['torch'][1]['dispatches'] == 1


def test_engine_rejects_disagreeing_leading_dims_and_empty(mlp_dir):
    for pkg in PACKAGES:
        eng = _mlp_engine(pkg, mlp_dir)
        eng._feed_names = None
        with pytest.raises(ValueError, match='leading'):
            eng.submit({'img': np.zeros((3, 784), 'float32'),
                        'y': np.zeros((2, 6), 'float32')})
        with pytest.raises(ValueError, match='0 rows'):
            eng.submit({'img': np.zeros((0, 784), 'float32')})
        with pytest.raises(ValueError, match='do not match'):
            _mlp_engine(pkg, mlp_dir).submit({'x': np.zeros((1, 784))})
        assert eng.metrics()['requests'] == 0


def test_engine_worker_survives_a_bad_lot(mlp_dir):
    """A request that breaks only at lot formation errors its own future;
    the worker keeps serving."""
    eng = _mlp_engine('torch', mlp_dir, max_batch_size=8, max_wait_ms=5)
    with eng:
        bad = tserving.InferenceRequest({'img': 'not-an-array'}, 2,
                                        ('forged', ))
        eng._batcher.submit(bad)
        with pytest.raises(Exception):
            bad.result(30)
        out, = eng.infer(_mlp_requests(11, [2])[0], timeout=30)
    assert out.shape == (2, 10)
    assert eng.metrics()['errors'] >= 1


def test_engine_inline_mode_concurrent_submitters(mlp_dir):
    eng = _mlp_engine('torch', mlp_dir)
    errors = []

    def client(cid):
        r = np.random.RandomState(100 + cid)
        try:
            for _ in range(6):
                n = int(r.randint(1, 5))
                out, = eng.infer({'img': r.rand(n, 784).astype('float32')},
                                 timeout=30)
                assert out.shape == (n, 10)
        except Exception as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c, ))
               for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert eng.metrics()['requests'] == 24


def _timeline():
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    try:
        from timeline import Timeline
    finally:
        sys.path.pop(0)
    return Timeline


def test_serving_spans_and_metrics_in_profiler_sidecar(mlp_dir, tmp_path):
    """The engine's spans (serving/<name>/...) and its metrics snapshot
    ride the port's profiler sidecar; tools/timeline.py renders one
    serving row per engine, and two engines of one name keep both
    snapshots."""
    p = str(tmp_path / 'prof')
    rng = np.random.RandomState(8)
    with tfluid.profiler.profiler('CPU', profile_path=p):
        for name, n in (('eng-a', 1), ('eng-b', 2), ('prod', 1),
                        ('prod', 2)):
            eng = tserving.InferenceEngine.from_saved_model(
                mlp_dir, place=tfluid.CPUPlace(), name=name)
            with eng:
                for _ in range(n):
                    eng.infer({'img': rng.rand(3, 784).astype('float32')},
                              timeout=30)
    sidecar = json.load(open(p + '.events.json'))
    names = {e['name'] for e in sidecar['host_events']}
    for n in ('eng-a', 'eng-b'):
        assert any(e.startswith('serving/%s/dispatch' % n) for e in names)
        assert 'serving/%s/queue_wait' % n in names
    assert sidecar['metrics']['eng-a']['requests'] == 1
    assert sidecar['metrics']['eng-b']['requests'] == 2
    assert sidecar['metrics']['eng-b']['batch_fill_ratio'] is not None
    prod = sorted(v['requests'] for k, v in sidecar['metrics'].items()
                  if k.startswith('prod'))
    assert prod == [1, 2]
    trace = json.loads(_timeline()({'t': sidecar}).generate_chrome_trace())
    rows = {e['args']['name'] for e in trace['traceEvents']
            if e['ph'] == 'M'}
    assert {'t:serving/eng-a', 't:serving/eng-b'} <= rows, rows


def test_request_trace_breakdown_and_tracing_spans(mlp_dir):
    """Each delivered request carries a trace id and stages summing to at
    most its end-to-end latency; a tracing() window records the engine's
    spans with the request's id."""
    eng = _mlp_engine('torch', mlp_dir)
    tfluid.trace.clear_spans()
    with tfluid.trace.tracing():
        fut = eng.submit(_mlp_requests(13, [3])[0])
        fut.result(30)
    bd = fut.breakdown()
    assert bd['trace_id'].startswith('tr-')
    assert sum(bd['stages_ms'].values()) <= bd['e2e_ms'] + 1e-6
    spans = tfluid.trace.spans()
    assert any(s['name'] == 'serving/%s/request' % eng.name and
               s.get('trace_id') == bd['trace_id'] for s in spans)


# ---- trailing buckets: LoD, PaddedSequence, dense ladders --------------

def test_engine_mixed_length_lod_matches_jax(seq_pair):
    """A mixed-length LoD stream coalesces over two rungs: fetches and
    counts (rung hits, padding waste, executables) as the JAX engine's,
    and each result bitwise equal to the port's per-request exe.run."""
    res = {}
    for pkg, (fluid, _) in PACKAGES.items():
        rng = np.random.RandomState(0)
        reqs = [_lod_request(fluid, rng, lens) for lens in SEQ_LENS]
        eng = _seq_engine(seq_pair, pkg, max_batch_size=16, max_wait_ms=0)
        res[pkg] = _deferred(eng, reqs) + (reqs, eng)
    _assert_same(res['jax'][0], res['torch'][0], MLP_TOL)
    mt = res['torch'][1]
    assert _counts(mt) == _counts(res['jax'][1])
    assert mt['lots'] < mt['requests']
    assert {'ids[1]:16', 'ids[1]:32'} <= set(mt['trailing_buckets']['hits'])
    assert 0.0 < mt['trailing_padding_waste'] < 1.0
    prog, pred, exe, scope = seq_pair['torch']
    for r, o in zip(res['torch'][2], res['torch'][0]):
        ref, = exe.run(prog, feed=r, fetch_list=[pred], scope=scope)
        assert np.array_equal(o[0], ref)


def test_padded_sequence_feeds_match_jax(seq_pair):
    """``core.PaddedSequence`` feeds: the executor feeds data and lengths
    as a lowered LoD feed (JAX's executor's result), and the engine
    re-pads an off-rung T to its rung and trims the fetch back."""
    rng = np.random.RandomState(2)
    data = rng.randint(0, 50, size=(2, 10, 1)).astype('int64')
    lengths = np.array([10, 6], np.int32)
    res = {}
    for pkg, (fluid, _) in PACKAGES.items():
        prog, pred, exe, scope = seq_pair[pkg]
        ps = fluid.core.PaddedSequence(data, lengths)
        ref, = exe.run(prog, feed={'ids': ps}, fetch_list=[pred],
                       scope=scope)
        eng = _seq_engine(seq_pair, pkg)
        c0 = eng._exe.compile_count
        out, = eng.infer({'ids': ps})
        assert out.shape == np.shape(ref)
        res[pkg] = (np.asarray(ref), out, _engine_counts(eng, c0))
    np.testing.assert_allclose(res['torch'][0], res['jax'][0], **MLP_TOL)
    np.testing.assert_allclose(res['torch'][1], res['jax'][1], **MLP_TOL)
    assert res['torch'][2] == res['jax'][2]
    assert res['torch'][2]['trailing'][0] == {'ids[1]:16': 1}
    # the same rows as a LoD feed give the same bits in the port
    prog, pred, exe, scope = seq_pair['torch']
    lod = tfluid.create_lod_tensor(
        [data[0, :10].tolist(), data[1, :6].tolist()], [[10, 6]])
    ref_lod, = exe.run(prog, feed={'ids': lod}, fetch_list=[pred],
                       scope=scope)
    assert np.array_equal(ref_lod, res['torch'][0])
    with pytest.raises(NotImplementedError, match='nested'):
        exe.run(prog, feed={'ids': tfluid.core.PaddedSequence(
            data, lengths, rows=np.array([2], np.int32))},
            fetch_list=[pred], scope=scope)


def test_dense_explicit_ladder_matches_jax():
    """The resolution-ladder opt-in on a dense feed: distinct lengths pad
    to shared rungs; fetches trim back to each request's extent; counts
    as the JAX engine's, at most half the exact-shape executables."""
    res = {}
    lengths = [5, 7, 9, 12, 14, 16, 3, 10]
    for pkg, (fluid, serving) in PACKAGES.items():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            x = fluid.layers.data('x', shape=[-1, 3], dtype='float32')
            y = fluid.layers.scale(x, scale=2.0)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.core.Scope()
        rng = np.random.RandomState(4)
        reqs = [{'x': rng.rand(2, l, 3).astype('float32')} for l in lengths]
        out = []
        for ladders in ({'x': [8, 16]}, None):
            eng = serving.InferenceEngine(
                prog, feed_names=['x'], fetch_list=[y], scope=scope,
                executor=fluid.Executor(fluid.CPUPlace()),
                place=fluid.CPUPlace(),
                config=serving.ServingConfig(max_batch_size=16,
                                             max_wait_ms=0,
                                             trailing_ladders=ladders))
            outs, m = _deferred(eng, reqs)
            out.append((outs, _counts(m)))
        for r, o in zip(reqs, out[0][0]):
            assert np.array_equal(o[0], 2.0 * r['x'])
        res[pkg] = out
    for k in range(2):
        _assert_same(res['jax'][k][0], res['torch'][k][0], MLP_TOL)
        assert res['torch'][k][1] == res['jax'][k][1]
    laddered, exact = res['torch'][0][1], res['torch'][1][1]
    assert laddered['executor_compile_count'] * 2 <= \
        exact['executor_compile_count']


def _two_feed_engine(pkg, order, ladders, fetch_width=None):
    fluid, serving = PACKAGES[pkg]
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        fa = fluid.layers.data(order[0], shape=[-1, 3], dtype='float32')
        fb = fluid.layers.data(order[1], shape=[-1, 3], dtype='float32')
        out = fluid.layers.elementwise_add(fa, fb)
    return serving.InferenceEngine(
        prog, feed_names=list(order), fetch_list=[out],
        scope=fluid.core.Scope(), place=fluid.CPUPlace(),
        executor=fluid.Executor(fluid.CPUPlace()),
        config=serving.ServingConfig(trailing_ladders=ladders))


@pytest.mark.parametrize('order', [('a', 'b'), ('b', 'a')])
def test_ambiguous_rung_claims_deliver_at_the_rung_like_jax(order):
    rng = np.random.RandomState(8)
    feed = {'a': rng.rand(2, 16, 3).astype('float32'),
            'b': rng.rand(2, 12, 3).astype('float32')}
    outs = {}
    for pkg in PACKAGES:
        eng = _two_feed_engine(pkg, order, {'a': [16], 'b': [16]})
        o, = eng.infer(feed)
        assert o.shape == (2, 16, 3)
        outs[pkg] = (o, _counts(eng.metrics()))
    np.testing.assert_allclose(outs['torch'][0], outs['jax'][0], **MLP_TOL)
    assert outs['torch'][1] == outs['jax'][1]


@pytest.mark.parametrize('case', ['bad_axis', 'zero_width'])
def test_rejected_request_leaves_no_trailing_trace(case):
    """A request rejected while its trailing axes are planned raises
    before any rung hit or padding cell is recorded."""
    for pkg in PACKAGES:
        if case == 'bad_axis':
            eng = _two_feed_engine(pkg, ('a', 'b'), {'a': {3: [16]}})
            feed = {'a': np.zeros((2, 5, 3), 'float32'),
                    'b': np.zeros((2, 5, 3), 'float32')}
            match = 'axis'
        else:
            eng = _two_feed_engine(pkg, ('a', 'b'), {'a': [16], 'b': [16]})
            feed = {'a': np.zeros((2, 0, 3), 'float32'),
                    'b': np.zeros((2, 4, 3), 'float32')}
            match = 'zero width'
        with pytest.raises(ValueError, match=match):
            eng.submit(feed)
        m = eng.metrics()
        assert m['trailing_buckets']['hits'] == {}
        assert m['trailing_padding_waste'] is None or \
            m['trailing_padding_waste'] == 0


def test_trailing_disabled_preserves_unbatchable_lod_path(seq_pair):
    """trailing_buckets=False: every LoD request is its own unpadded lot,
    with the JAX engine's counts."""
    res = {}
    for pkg, (fluid, _) in PACKAGES.items():
        rng = np.random.RandomState(1)
        reqs = [_lod_request(fluid, rng, lens) for lens in SEQ_LENS[:3]]
        eng = _seq_engine(seq_pair, pkg, trailing_buckets=False,
                          max_wait_ms=0)
        res[pkg] = _deferred(eng, reqs)
    _assert_same(res['jax'][0], res['torch'][0], MLP_TOL)
    assert _counts(res['torch'][1]) == _counts(res['jax'][1])
    assert res['torch'][1]['lots'] == 3


def test_fetch_static_width_voids_coinciding_trim():
    """A fetch whose static axis 1 equals the rung is not trimmed (it is
    the fetch's own width, not the padding): the same shapes as the JAX
    engine's."""
    outs = {}
    for pkg, (fluid, serving) in PACKAGES.items():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            x = fluid.layers.data('x', shape=[-1, 3], dtype='float32')
            pooled = fluid.layers.reduce_sum(x, dim=1)
            h = fluid.layers.fc(pooled, 16, param_attr=fluid.ParamAttr(
                name='w16', initializer=fluid.initializer.Constant(0.5)),
                bias_attr=False)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.core.Scope()
        exe.run(startup, scope=scope)
        eng = serving.InferenceEngine(
            prog, feed_names=['x'], fetch_list=[h], scope=scope,
            executor=exe, place=fluid.CPUPlace(),
            config=serving.ServingConfig(trailing_ladders={'x': [16]}))
        o, = eng.infer({'x': np.ones((2, 12, 3), 'float32')})
        outs[pkg] = o
    assert outs['torch'].shape == outs['jax'].shape == (2, 16)
    np.testing.assert_allclose(outs['torch'], outs['jax'], **MLP_TOL)


# ---- the Transformer served ---------------------------------------------

def test_transformer_trailing_stream_matches_jax(transformer_pair):
    """The n_layer=2 Transformer's test program served as the card's H1
    path serves Transformer-base: requests of 4 rows at lengths L/4, L/2,
    3L/4 and L, every id feed on the explicit ladder [L], one 16-row lot.
    Fetches match the JAX engine's; counts equal; the port's result is
    its own exe.run on the zero-padded request (the fetch's static axis 1
    is the rung, so it is delivered at the rung)."""
    L = SMALL_TF['max_len']
    reqs = _tf_requests(2, [L // 4, L // 2, 3 * L // 4, L])
    ladders = {n: [L] for n in ('src_ids', 'trg_ids', 'lbl_ids')}
    cfg = dict(max_batch_size=16, max_wait_ms=0, trailing_ladders=ladders)
    outs_j, mj = _deferred(_tf_engine(transformer_pair, 'jax', **cfg), reqs)
    eng = _tf_engine(transformer_pair, 'torch', **cfg)
    outs_t, mt = _deferred(eng, reqs)
    _assert_same(outs_j, outs_t, TF_TOL)
    assert _counts(mt) == _counts(mj)
    assert mt['lots'] == 1 < mt['requests'] == 4
    assert mt['trailing_padding_waste'] == pytest.approx(
        1 - (1 + 2 + 3 + 4) / 16.0)
    m, scope, exe = transformer_pair['torch']
    for r, o in zip(reqs, outs_t):
        padded = {n: np.pad(v, ((0, 0), (0, L - v.shape[1])))
                  for n, v in r.items()}
        ref, = exe.run(m['test'], feed=padded, fetch_list=[m['prediction']],
                       scope=scope)
        assert o[0].shape == (4, L, SMALL_TF['trg_vocab'])
        np.testing.assert_allclose(o[0], ref, rtol=0, atol=1e-6)


def test_transformer_queued_engine_matches_jax(transformer_pair):
    """The same stream through a started engine, lots of 8 rows, two
    lots per dispatch."""
    L = SMALL_TF['max_len']
    reqs = _tf_requests(3, [L, L // 2, L, 3 * L // 4], rows=4)
    ladders = {n: [L] for n in ('src_ids', 'trg_ids', 'lbl_ids')}
    eng = _tf_engine(transformer_pair, 'torch', max_batch_size=8,
                     max_wait_ms=60000, steps_per_dispatch=2,
                     trailing_ladders=ladders)
    with eng:
        with eng.paused():
            futs = [eng.submit(r) for r in reqs]
    outs = [f.result(30) for f in futs]
    m = eng.metrics()
    assert m['lots'] == 2 and m['requests'] == 4
    jeng = _tf_engine(transformer_pair, 'jax', trailing_ladders=ladders)
    _assert_same([jeng.infer(r) for r in reqs], outs, TF_TOL)


# ---- SLO scheduling in the engine --------------------------------------

def test_engine_sheds_expired_request_typed_and_staged(mlp_dir):
    """An expired request sheds with DeadlineExceededError and a 'shed'
    stage, counted as shed (not an error), as in the JAX engine; a
    request within its deadline is identical to an undeadlined one."""
    res = {}
    for pkg, (fluid, serving) in PACKAGES.items():
        eng = _mlp_engine(pkg, mlp_dir)
        c0 = eng._exe.compile_count
        req = _mlp_requests(14, [2])[0]
        with pytest.raises(serving.DeadlineExceededError) as ei:
            eng.submit(req, deadline_ms=-1.0).result(30)
        assert ei.value.where == 'queue'
        plain, = eng.infer(req)
        dl, = eng.submit(req, deadline_ms=60000.0, priority=2).result(30)
        assert np.array_equal(plain, dl)
        res[pkg] = _engine_counts(eng, c0)
    assert res['torch'] == res['jax']
    assert res['torch']['shed'] == 1 and res['torch']['errors'] == 0


def test_queue_age_rides_engine_metrics(mlp_dir):
    eng = _mlp_engine('torch', mlp_dir, max_batch_size=64,
                      max_wait_ms=60000)
    with eng:
        assert eng.metrics()['queue_age_oldest_s'] is None
        with eng.paused():
            fut = eng.submit(_mlp_requests(15, [1])[0])
            assert eng.queue_depth() == 1
            assert eng.metrics()['queue_age_oldest_s'] >= 0
    fut.result(30)
    assert eng.metrics()['queue_age_oldest_s'] is None


# ---- what this slice does not port -------------------------------------

@pytest.mark.parametrize('cut', ['parallel', 'mesh', 'embed_caches'])
def test_cut_features_raise_not_implemented(mlp_dir, cut):
    eng = _mlp_engine('torch', mlp_dir)
    args = dict(fetch_list=eng._fetch_list, scope=eng._scope,
                executor=eng._exe)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        value = {'parallel': True, 'mesh': {'dp': 2},
                 'embed_caches': [object()]}[cut]
        tserving.InferenceEngine(eng._program, **dict(args, **{cut: value}))


def test_engine_runs_on_the_card_unless_given_cpu(mlp_dir, monkeypatch):
    """No place: CUDAPlace(0), which needs a card (here none)."""
    eng = _mlp_engine('torch', mlp_dir)
    assert eng.place == tfluid.CPUPlace()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        tserving.InferenceEngine.from_saved_model(mlp_dir)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        tserving.InferenceEngine(eng._program, fetch_list=eng._fetch_list)
