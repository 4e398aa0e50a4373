"""The PyTorch port's input pipeline held against the JAX package on the
CPU (``CPUPlace()``): reader-fed ``run_multi`` and ``run_eval_multi``
(K distinct batches a dispatch, a partial tail, a bucket boundary's batch
pushed back, then ``EOFException``), ``fluid.FeedPipeline`` (background
staging, ``pipeline_depth``, ``bucketed`` blocks and ``dispatch_log``, its
metrics and profiler spans, the typed close-race error), the py_reader
prefetch thread's lifecycle, the pipelined ``Trainer`` loop, and two
serving engines on one executor.  Each case mirrors one of
``tests/test_input_pipeline.py`` (its twenty cases that need no
``ParallelExecutor``) or ``tests/test_trailing_buckets.py``'s two
``bucketed=True`` cases.

Both packages build the same program with the same names; the port's
scope takes the JAX package's startup state, and both get the same seeded
numpy batches.  Losses, predictions and parameters are held with
``allclose`` at rtol 1e-5, atol 1e-6: the same f32 arithmetic up to
summation order, over at most eight SGD steps at lr 0.5 of a 4-3 fc.
Contract cases compare what each package does: the exception's type and
message, the batches consumed, the metrics, ``dispatch_log``.  Within the
port, as in the JAX package, a reader-fed or pipelined run is bitwise equal
to the same batches run one ``run()`` call at a time.

Threads are synchronized on events, never on sleeps, and every test runs
under a time limit of its own (``faulthandler``: a hang dumps the stacks
and ends the process instead of holding up the suite).
"""

import faulthandler
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
TIME_LIMIT_S = 120
PKGS = (('jax', jfluid), ('torch', tfluid))


@pytest.fixture(autouse=True)
def _names_and_time_limit():
    """Names made afresh in both packages (the global counters as they
    were), and the test's own time limit."""
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    try:
        with jfluid.unique_name.guard(), tfluid.unique_name.guard():
            yield
    finally:
        faulthandler.cancel_dump_traceback_later()


# ---- programs, state hand-over, batches ---------------------------------

def _reader_prog(fluid, batches, seed=0, train=True):
    """A py_reader-fed 4-3 softmax classifier (SGD at lr 0.5 when
    ``train``) and its provider."""
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = seed
    with fluid.program_guard(prog, startup):
        rd = fluid.layers.py_reader(capacity=8, shapes=[[-1, 4], [-1, 1]],
                                    dtypes=['float32', 'int64'])
        x, label = fluid.layers.read_file(rd)
        pred = fluid.layers.fc(x, 3, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        if train:
            fluid.optimizer.SGD(0.5).minimize(loss)
    rd.decorate_tensor_provider(lambda: iter(batches))
    return dict(prog=prog, startup=startup, rd=rd, pred=pred, loss=loss)


def _data_prog(fluid, seed=0):
    """The same classifier fed by data layers 'x' and 'label'."""
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = seed
    with fluid.program_guard(prog, startup):
        x = fluid.layers.data('x', [4])
        label = fluid.layers.data('label', [1], dtype='int64')
        pred = fluid.layers.fc(x, 3, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.SGD(0.5).minimize(loss)
    return dict(prog=prog, startup=startup, pred=pred, loss=loss)


def _value(pkg, scope, name):
    if pkg == 'jax':
        return np.array(jfluid.executor.as_numpy(scope.find_var(name).value()))
    v = scope.find_var(name).value()
    return (v.tensor() if isinstance(v, tfluid.LoDTensor) else v).numpy()


def _state(pkg, prog, scope):
    """{name: array} of the program's persistable tensors in ``scope``."""
    out = {}
    for v in prog.list_vars():
        if not v.persistable or \
                v.type == jfluid.core.VarDesc.VarType.READER:
            continue
        var = scope.find_var(v.name)
        if var is not None and var.value() is not None:
            out[v.name] = _value(pkg, scope, v.name)
    return out


def _both(build, *args, **kwargs):
    """``build(fluid, ...)`` in each package, each with a CPU executor and
    a scope: the JAX package runs its startup, the port's scope takes the
    JAX package's startup state.  Returns {pkg: (fluid, model, exe,
    scope)}."""
    out = {}
    start = None
    for pkg, fluid in PKGS:
        m = build(fluid, *args, **kwargs)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.core.Scope()
        if pkg == 'jax':
            exe.run(m['startup'], scope=scope)
            start = _state('jax', m['prog'], scope)
        else:
            for name, arr in start.items():
                scope.var(name).set_value(torch.tensor(arr))
        out[pkg] = (fluid, m, exe, scope)
    return out


def _param(pkg, m, scope, suffix='.w_0'):
    name = [v for v in m['prog'].global_block().vars
            if v.endswith(suffix)][0]
    return _value(pkg, scope, name)


def _batches(n, rows=8, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(rows, 4).astype('float32'),
             rng.randint(0, 3, (rows, 1)).astype('int64'))
            for _ in range(n)]


def _sequential(pair):
    """run() calls of each package over its reader to the end of the
    pass: the right side of the reader-fed contract.  {pkg: (last loss,
    w)}."""
    out = {}
    for pkg, (fluid, m, exe, scope) in pair.items():
        with fluid.scope_guard(scope):
            m['rd'].start()
            while True:
                try:
                    last, = exe.run(m['prog'], fetch_list=[m['loss']])
                except fluid.core.EOFException:
                    break
            m['rd'].reset()
        out[pkg] = (np.asarray(last), _param(pkg, m, scope))
    return out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **TOL)


# ---- reader-fed run_multi ------------------------------------------------

def test_reader_fed_run_multi_equals_sequential_like_jax():
    """run_multi(reader=..., steps=K) trains on K distinct batches: the
    loss and the parameters equal K run() calls over the same stream
    (bitwise within each package), and the port's equal the JAX
    package's."""
    batches = _batches(6)
    seq = _sequential(_both(_reader_prog, batches))
    got = {}
    for pkg, (fluid, m, exe, scope) in _both(_reader_prog, batches).items():
        with fluid.scope_guard(scope):
            m['rd'].start()
            out, = exe.run_multi(m['prog'], reader=m['rd'],
                                 fetch_list=[m['loss']], steps=6)
        got[pkg] = (np.asarray(out), _param(pkg, m, scope))
        np.testing.assert_array_equal(seq[pkg][0], got[pkg][0])
        np.testing.assert_array_equal(seq[pkg][1], got[pkg][1])
    for i in range(2):
        _close(got['torch'][i], got['jax'][i])


def test_reader_fed_run_multi_partial_tail_then_eof_like_jax():
    """A stream ending mid-block trains on the shorter tail; the next
    reader-fed call raises EOFException, in both packages."""
    batches = _batches(5)
    seq = _sequential(_both(_reader_prog, batches))
    got = {}
    for pkg, (fluid, m, exe, scope) in _both(_reader_prog, batches).items():
        with fluid.scope_guard(scope):
            m['rd'].start()
            exe.run_multi(m['prog'], reader=m['rd'], fetch_list=[m['loss']],
                          steps=3)
            tail, = exe.run_multi(m['prog'], reader=m['rd'],
                                  fetch_list=[m['loss']], steps=3)
            with pytest.raises(fluid.core.EOFException):
                exe.run_multi(m['prog'], reader=m['rd'],
                              fetch_list=[m['loss']], steps=3)
        got[pkg] = (np.asarray(tail), _param(pkg, m, scope))
        np.testing.assert_array_equal(seq[pkg][0], got[pkg][0])
        np.testing.assert_array_equal(seq[pkg][1], got[pkg][1])
    _close(got['torch'][1], got['jax'][1])


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the contract compared is the exception
        return type(e).__name__, str(e)
    return None


def test_run_multi_plain_feed_rejects_reader_programs_like_jax():
    """Without reader= the plain paths refuse a reader-fed program (they
    would train K steps on one batch); reader= with feed= is refused.
    The same exceptions, with the same messages, in both packages."""
    raised = {}
    for pkg, (fluid, m, exe, scope) in _both(
            _reader_prog, _batches(2)).items():
        with fluid.scope_guard(scope):
            raised[pkg] = [
                _raised(lambda: exe.run_multi(m['prog'], feed={},
                                              fetch_list=[m['loss']],
                                              steps=2)),
                _raised(lambda: exe.run_multi(m['prog'], reader=m['rd'],
                                              feed={},
                                              fetch_list=[m['loss']],
                                              steps=2))]
    assert raised['torch'] == raised['jax']
    assert raised['torch'][0][0] == 'RuntimeError'
    assert 'run_multi(reader=' in raised['torch'][0][1]
    assert raised['torch'][1] == ('ValueError',
                                  'run_multi: pass reader= OR feed/feed_list')


def test_reader_fed_run_multi_ragged_tail_pushback_like_jax():
    """The drain stops at a shape-bucket boundary: the ragged tail goes
    back to the stream and trains at the next call; then EOF."""
    batches = _batches(4) + _batches(1, rows=3, seed=9)
    seq = _sequential(_both(_reader_prog, batches))
    got = {}
    for pkg, (fluid, m, exe, scope) in _both(_reader_prog, batches).items():
        with fluid.scope_guard(scope):
            m['rd'].start()
            exe.run_multi(m['prog'], reader=m['rd'], fetch_list=[m['loss']],
                          steps=5)
            tail, = exe.run_multi(m['prog'], reader=m['rd'],
                                  fetch_list=[m['loss']], steps=5)
            with pytest.raises(fluid.core.EOFException):
                exe.run_multi(m['prog'], reader=m['rd'],
                              fetch_list=[m['loss']], steps=1)
        got[pkg] = (np.asarray(tail), _param(pkg, m, scope))
        np.testing.assert_array_equal(seq[pkg][0], got[pkg][0])
        np.testing.assert_array_equal(seq[pkg][1], got[pkg][1])
    _close(got['torch'][0], got['jax'][0])
    _close(got['torch'][1], got['jax'][1])


# ---- FeedPipeline ---------------------------------------------------------

METRIC_KEYS = ('dispatches', 'blocks_staged', 'steps_dispatched', 'eof',
               'partial_blocks', 'pipeline_depth', 'steps_per_dispatch',
               'bucketed', 'open_buckets', 'bucket_early_flushes',
               'queue_depth', 'inflight')


def _pipeline(pair, **kwargs):
    """Each package's FeedPipeline over its reader: {pkg: (outs, w,
    metrics, pipe)}."""
    out = {}
    for pkg, (fluid, m, exe, scope) in pair.items():
        with fluid.scope_guard(scope):
            m['rd'].start()
            pipe = fluid.FeedPipeline(exe, fetch_list=[m['loss']],
                                      program=m['prog'], reader=m['rd'],
                                      scope=scope, **kwargs)
            outs = pipe.run()
        out[pkg] = (outs, _param(pkg, m, scope), pipe.metrics(), pipe)
    return out


def test_feed_pipeline_reader_matches_sequential_like_jax():
    """The overlapped pipeline (staging thread, depth 2) trains as the
    sequential run() calls do, and reports the same counters."""
    batches = _batches(6)
    seq = _sequential(_both(_reader_prog, batches))
    got = _pipeline(_both(_reader_prog, batches), steps=2, pipeline_depth=2)
    for pkg, (outs, w, m, _) in got.items():
        assert len(outs) == 3
        np.testing.assert_array_equal(seq[pkg][0], np.asarray(outs[-1][0]))
        np.testing.assert_array_equal(seq[pkg][1], w)
        assert 0.0 <= m['overlap_ratio'] <= 1.0 and m['feed_stall_s'] >= 0
    mj, mt = got['jax'][2], got['torch'][2]
    assert {k: mt[k] for k in METRIC_KEYS} == {k: mj[k] for k in METRIC_KEYS}
    assert mt['dispatches'] == 3 and mt['steps_dispatched'] == 6
    _close(got['torch'][1], got['jax'][1])
    for oj, ot in zip(got['jax'][0], got['torch'][0]):
        _close(ot[0], oj[0])


def _source_prog(fluid):
    m = _data_prog(fluid)
    m['rd'] = None
    return m


def test_feed_pipeline_source_error_propagates_like_jax():
    """A source raising mid-stream fails the consumer with the original
    error chained (a FeedPipelineError, a RuntimeError): no hang, no
    silent end."""
    def bad_source():
        yield {'x': np.ones((4, 4), np.float32),
               'label': np.zeros((4, 1), np.int64)}
        raise RuntimeError('disk on fire')

    raised = {}
    for pkg, (fluid, m, exe, scope) in _both(_source_prog).items():
        with fluid.scope_guard(scope):
            pipe = fluid.FeedPipeline(exe, fetch_list=[m['loss']],
                                      program=m['prog'], source=bad_source(),
                                      steps=1)
            with pytest.raises(RuntimeError, match='disk on fire') as ei:
                pipe.run()
        raised[pkg] = (type(ei.value).__name__,
                       type(ei.value.__cause__).__name__,
                       pipe.metrics()['dispatches'])
    assert raised['torch'] == raised['jax'] == (
        'FeedPipelineError', 'RuntimeError', 1)


def test_feed_pipeline_profiler_sidecar_and_timeline_row_like_jax(tmp_path):
    """Inside a profiler window the pipeline's stage and dispatch spans
    land in the sidecar and its metrics snapshot outlives its close;
    tools/timeline.py renders them in a :pipeline row.  The same span
    names and snapshot counters in both packages."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    from timeline import Timeline
    seen = {}
    for pkg, (fluid, m, exe, scope) in _both(_reader_prog,
                                             _batches(6)).items():
        p = str(tmp_path / ('prof_' + pkg))
        with fluid.scope_guard(scope):
            m['rd'].start()
            with fluid.profiler.profiler('CPU', profile_path=p):
                fluid.FeedPipeline(exe, fetch_list=[m['loss']],
                                   program=m['prog'], reader=m['rd'],
                                   steps=2, pipeline_depth=2, scope=scope,
                                   name='pipe-under-test').run()
        with open(p + '.events.json') as f:
            sidecar = json.load(f)
        names = {e['name'] for e in sidecar['host_events']
                 if e['name'].startswith('pipeline/') and
                 'feed_stall' not in e['name']}
        snap = sidecar['metrics']['pipe-under-test']
        trace = json.loads(Timeline({'t': sidecar}).generate_chrome_trace())
        rows = {e['args']['name'] for e in trace['traceEvents']
                if e['ph'] == 'M'}
        cats = {e['cat'] for e in trace['traceEvents'] if e['ph'] == 'X'}
        seen[pkg] = (names, snap['dispatches'], 't:pipeline' in rows,
                     'pipeline' in cats)
        assert 0.0 <= snap['overlap_ratio'] <= 1.0
    assert seen['torch'] == seen['jax']
    assert seen['torch'] == ({'pipeline/stage[x2]', 'pipeline/dispatch[x2]'},
                             3, True, True)


def test_feed_pipeline_ragged_final_batch_splits_block_like_jax():
    """A smaller final batch closes the block at the bucket boundary and
    trains as its own shorter dispatch."""
    batches = _batches(5) + _batches(1, rows=3, seed=9)
    seq = _sequential(_both(_reader_prog, batches))
    got = _pipeline(_both(_reader_prog, batches), steps=2, pipeline_depth=2)
    for pkg, (outs, w, m, _) in got.items():
        assert len(outs) == 4
        np.testing.assert_array_equal(seq[pkg][0], np.asarray(outs[-1][0]))
        np.testing.assert_array_equal(seq[pkg][1], w)
    mj, mt = got['jax'][2], got['torch'][2]
    assert {k: mt[k] for k in METRIC_KEYS} == {k: mj[k] for k in METRIC_KEYS}
    assert mt['steps_dispatched'] == 6 and mt['partial_blocks'] == 2
    _close(got['torch'][1], got['jax'][1])


def test_pipeline_close_mid_drain_stops_consuming_the_reader_like_jax():
    """Leaving the pipeline early stops the staging thread between pops:
    after close() at most the one pop in flight completes, in both
    packages.  The source stalls in the third block, which the stager is
    draining once two dispatches are in flight; close() releases it once
    it has marked the pipeline closed, and its join waits for the
    stager."""
    counts = {}
    for pkg, (fluid, m, exe, scope) in _both(_reader_prog, []).items():
        gate = threading.Event()

        def provider():
            for i in range(12):
                if i == 9:
                    gate.wait(30)  # stall mid-block, so close() races a drain
                yield (np.full((8, 4), float(i), np.float32),
                       np.zeros((8, 1), np.int64))

        feeder = fluid.layers.io.get_reader_feeder(m['rd'].name)
        feeder.decorate_tensor_provider(provider)
        pops = []
        pop = feeder.pop
        feeder.pop = lambda: (pops.append(1), pop())[1]
        with fluid.scope_guard(scope):
            m['rd'].start()
            pipe = fluid.FeedPipeline(exe, fetch_list=[m['loss']],
                                      program=m['prog'], reader=m['rd'],
                                      steps=4, pipeline_depth=2,
                                      scope=scope)
            it = iter(pipe)
            next(it)  # two dispatches; the stager drains the third block
            before = len(pops)
            drain = pipe._drain_staged

            def release_then_drain():
                gate.set()  # the pipeline is closed by now
                drain()

            pipe._drain_staged = release_then_drain
            pipe.close()
            assert pipe._thread is None  # the stager was joined
            counts[pkg] = len(pops) - before
        m['rd'].reset()
    assert counts['torch'] == counts['jax'] and counts['torch'] <= 1


def test_feed_pipeline_close_race_error_surfaces_once_typed_like_jax():
    """A staging-thread exception racing close() surfaces once, as
    FeedPipelineError with the original as its cause; a second close() is
    silent; and the iteration path raises the same type once."""
    outcome = {}
    for pkg, (fluid, m, exe, scope) in _both(_source_prog).items():
        gate, reached = threading.Event(), threading.Event()

        def faulting_source():
            yield {'x': np.ones((4, 4), np.float32),
                   'label': np.zeros((4, 1), np.int64)}
            reached.set()
            gate.wait(30)
            raise ValueError('injected reader fault')

        with fluid.scope_guard(scope):
            pipe = fluid.FeedPipeline(exe, fetch_list=[m['loss']],
                                      program=m['prog'],
                                      source=faulting_source(), steps=2)
            pipe.start()
            # steps=2: the block stays open, the stager is mid-drain
            assert reached.wait(30)
            drain = pipe._drain_staged

            def release_then_drain():
                gate.set()  # the stager raises while close() joins it
                drain()

            pipe._drain_staged = release_then_drain
            with pytest.raises(fluid.dataflow.FeedPipelineError) as ei:
                pipe.close()
            cause = type(ei.value.__cause__).__name__
            pipe.close()  # delivered once: silent now

            def bad_source():
                yield {'x': np.ones((4, 4), np.float32),
                       'label': np.zeros((4, 1), np.int64)}
                raise ValueError('mid-pass fault')

            pipe2 = fluid.FeedPipeline(exe, fetch_list=[m['loss']],
                                       program=m['prog'],
                                       source=bad_source(), steps=1)
            with pytest.raises(fluid.dataflow.FeedPipelineError):
                pipe2.run()
            pipe2.close()
        outcome[pkg] = cause
    assert outcome['torch'] == outcome['jax'] == 'ValueError'


def _skewed(pattern, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(r, 4).astype('float32'),
             rng.randint(0, 3, (r, 1)).astype('int64')) for r in pattern]


def test_feed_pipeline_bucketed_routes_and_matches_replay_like_jax():
    """bucketed=True: interleaved shape buckets pipeline full K-step
    blocks; dispatch_log records the realized order, the same in both
    packages; the state equals sequential run() calls in that order."""
    batches = _skewed([8, 5, 8, 5, 8, 5, 8], 0)
    got = _pipeline(_both(_reader_prog, batches), steps=2, pipeline_depth=2,
                    bucketed=True)
    for pkg, (outs, w, m, pipe) in got.items():
        assert list(pipe.dispatch_log) == [[0, 2], [1, 3], [4, 6], [5]]
        assert pipe.dispatch_log.maxlen is not None
        assert m['bucketed'] is True and m['dispatches'] == 4
        assert m['partial_blocks'] == 1 and m['eof'] is True
        assert m['open_buckets'] == 0
    order = [i for d in got['torch'][3].dispatch_log for i in d]
    seq = _sequential(_both(_reader_prog, [batches[i] for i in order]))
    for pkg, (outs, w, m, pipe) in got.items():
        np.testing.assert_array_equal(np.asarray(outs[-1][0]), seq[pkg][0])
        np.testing.assert_array_equal(w, seq[pkg][1])
    _close(got['torch'][1], got['jax'][1])


def test_feed_pipeline_bucketed_open_bucket_bound_like_jax():
    """More open buckets than max_open_buckets flush the least recently
    fed one early; nothing is dropped; the same flushes and order in both
    packages."""
    batches = _skewed([8, 5, 3, 8, 5, 3], 1)
    got = _pipeline(_both(_reader_prog, batches, seed=2), steps=4,
                    pipeline_depth=2, bucketed=True, max_open_buckets=2)
    for pkg, (outs, w, m, pipe) in got.items():
        assert m['bucket_early_flushes'] >= 1
        trained = sorted(i for d in pipe.dispatch_log for i in d)
        assert trained == list(range(len(batches)))
        assert m['steps_dispatched'] == len(batches)
        assert len(outs) == m['dispatches']
    assert list(got['torch'][3].dispatch_log) == \
        list(got['jax'][3].dispatch_log)
    assert got['torch'][2]['bucket_early_flushes'] == \
        got['jax'][2]['bucket_early_flushes']
    _close(got['torch'][1], got['jax'][1])


def test_feed_pipeline_bucketed_captures_one_block_a_signature():
    """In the port each feed signature of a bucketed pipeline resolves one
    block of its own (one captured graph on the card): two signatures, two
    blocks, each run with K-step blocks."""
    batches = _skewed([8, 5, 8, 5], 3)
    pair = _both(_reader_prog, batches)
    fluid, m, exe, scope = pair['torch']
    with fluid.scope_guard(scope):
        m['rd'].start()
        pipe = fluid.FeedPipeline(exe, fetch_list=[m['loss']],
                                  program=m['prog'], reader=m['rd'],
                                  steps=2, scope=scope, bucketed=True)
        pipe.run()
    blocks = [c for c in exe.cached_blocks() if c.program is m['prog']]
    sigs = sorted(tuple(s[1] for s in c.multi_steps_seen) for c in blocks)
    assert len(blocks) == 2 and pipe.metrics()['dispatches'] == 2
    assert all(len(c.multi_steps_seen) == 1 for c in blocks), sigs


# ---- py_reader prefetch-thread lifecycle ----------------------------------

def _db_reader(fluid, provider, capacity=4):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        rd = fluid.layers.py_reader(capacity=capacity, shapes=[[-1, 4]],
                                    dtypes=['float32'])
        fluid.layers.read_file(rd)
    rd.decorate_tensor_provider(provider)
    fluid.layers.io.double_buffer(rd, place=fluid.CPUPlace())
    return rd, fluid.layers.io.get_reader_feeder(rd.name)


def _first(batch):
    return float(np.asarray(batch[0]).flat[0])


def test_py_reader_reset_races_inflight_prefetch_like_jax():
    """reset() while the prefetch threads are in flight joins both, and a
    restarted pass delivers its own first batch, never a staged batch of
    the aborted one.  The provider signals once the prefetcher has run
    ahead of the consumer."""
    seen = {}
    for pkg, fluid in PKGS:
        tag = [1.0]
        ahead = threading.Event()

        def provider():
            i = 0
            while True:  # unbounded: the prefetcher is always in flight
                if i == 3:
                    ahead.set()
                yield (np.full((4, 4), tag[0] * 1000 + i, np.float32), )
                i += 1

        rd, feeder = _db_reader(fluid, provider)
        firsts, stopped = [], []
        for _ in range(3):
            ahead.clear()
            rd.start()
            firsts.append(_first(feeder.pop()))
            assert ahead.wait(30)  # the prefetcher ran ahead
            rd.reset()
            stopped.append((feeder._thread, feeder._convert_thread,
                            feeder._dev_queue))
            tag[0] += 1.0
        seen[pkg] = (firsts, stopped)
    assert seen['torch'] == seen['jax']
    assert seen['torch'][0] == [1000.0, 2000.0, 3000.0]
    assert seen['torch'][1] == [(None, None, None)] * 3


def test_double_buffer_worker_shutdown_on_eof_like_jax():
    """A finite provider winds the prefetch down: EOF once and sticky,
    both threads exit without reset(), and reset() + start() runs the next
    pass."""
    seen = {}
    for pkg, fluid in PKGS:
        def provider():
            for i in range(3):
                yield (np.full((4, 4), i, np.float32), )

        rd, feeder = _db_reader(fluid, provider)
        rd.start()
        got = []
        while True:
            batch = feeder.pop()
            if batch is None:
                break
            got.append(_first(batch))
        sticky = feeder.pop() is None
        feeder._thread.join(timeout=30)
        feeder._convert_thread.join(timeout=30)
        alive = (feeder._thread.is_alive(), feeder._convert_thread.is_alive())
        rd.reset()
        rd.start()
        again = _first(feeder.pop())
        rd.reset()
        seen[pkg] = (got, sticky, alive, again)
    assert seen['torch'] == seen['jax'] == ([0.0, 1.0, 2.0], True,
                                            (False, False), 0.0)


def test_double_buffer_provider_error_surfaces_once_like_jax():
    """A provider crash surfaces as RuntimeError on the pop that reaches
    it, and the prefetch threads stop."""
    seen = {}
    for pkg, fluid in PKGS:
        def provider():
            yield (np.zeros((4, 4), np.float32), )
            raise ValueError('bad shard')

        rd, feeder = _db_reader(fluid, provider)
        rd.start()
        assert feeder.pop() is not None
        with pytest.raises(RuntimeError, match='bad shard') as ei:
            while feeder.pop() is not None:
                pass
        rd.reset()
        seen[pkg] = (type(ei.value).__name__, feeder._thread,
                     feeder._convert_thread)
    assert seen['torch'] == seen['jax'] == ('RuntimeError', None, None)


def _wait_for(cond, limit_s=30):
    """Wait until ``cond()`` holds (a state, not a time): True, or False
    after ``limit_s``."""
    tick = threading.Event()
    for _ in range(int(limit_s * 1000)):
        if cond():
            return True
        tick.wait(0.001)
    return False


def _wait_in(thread, names):
    """Wait until ``thread``'s stack holds a frame of each function in
    ``names`` (the consumer blocked inside pop)."""
    def stack():
        frame = sys._current_frames().get(thread.ident)
        out = set()
        while frame is not None:
            out.add(frame.f_code.co_name)
            frame = frame.f_back
        return out
    return _wait_for(lambda: set(names) <= stack())


def test_reset_unblocks_a_pop_in_flight_like_jax():
    """A consumer blocked in pop() (the provider starved mid-pass) while
    another thread resets the pass gets EOF instead of hanging."""
    seen = {}
    for pkg, fluid in PKGS:
        release = threading.Event()

        def provider():
            yield (np.zeros((4, 4), np.float32), )
            release.wait(30)  # starve the prefetcher mid-pass
            yield (np.ones((4, 4), np.float32), )

        rd, feeder = _db_reader(fluid, provider)
        rd.start()
        assert feeder.pop() is not None
        result = {}
        t = threading.Thread(target=lambda: result.setdefault(
            'batch', feeder.pop()), daemon=True)
        t.start()
        assert _wait_in(t, ('pop', 'get'))  # blocked on the empty queue
        # the starved provider is let go once reset() has closed the pass
        # (its threads then exit without delivering), so that reset()'s
        # join of the producer does not wait out its time limit
        closer = threading.Thread(
            target=lambda: _wait_for(lambda: feeder._closed) and
            release.set(), daemon=True)
        closer.start()
        rd.reset()
        t.join(timeout=30)
        closer.join(timeout=30)
        seen[pkg] = (t.is_alive(), result.get('batch', 'missing'))
    assert seen['torch'] == seen['jax'] == (False, None)


def test_push_back_is_dropped_across_reset_like_jax():
    """A batch popped in pass N and pushed back after reset() + start()
    is dropped; within one pass push_back round-trips."""
    seen = {}
    for pkg, fluid in PKGS:
        def provider():
            for i in range(3):
                yield (np.full((4, 4), i, np.float32), )

        rd, feeder = _db_reader(fluid, provider)
        rd.start()
        stale = feeder.pop()
        rd.reset()
        rd.start()
        feeder.push_back(stale)  # raced: the pop predates the reset
        fresh = _first(feeder.pop())
        nxt = feeder.pop()
        feeder.push_back(nxt)
        again = feeder.pop()
        rd.reset()
        seen[pkg] = (_first(stale), fresh, _first(nxt), _first(again))
    assert seen['torch'] == seen['jax'] == (0.0, 0.0, 1.0, 1.0)


# ---- reader-fed run_eval_multi ---------------------------------------------

def test_reader_fed_run_eval_multi_equals_sequential_like_jax():
    """run_eval_multi(reader=..., steps=K) evaluates K distinct batches in
    one dispatch and returns every step's fetches, equal to K run() pops
    (bitwise within each package), the port's to the JAX package's."""
    batches = _batches(4, seed=11)
    got = {}
    for pkg, (fluid, m, exe, scope) in _both(_reader_prog, batches,
                                             train=False).items():
        with fluid.scope_guard(scope):
            m['rd'].start()
            seq = [np.asarray(exe.run(m['prog'], fetch_list=[m['pred']])[0])
                   for _ in range(4)]
            m['rd'].reset()
            m['rd'].start()
            outs = exe.run_eval_multi(m['prog'], reader=m['rd'],
                                      fetch_list=[m['pred']], steps=4)
        assert outs[0].shape == (4, 8, 3)
        for k in range(4):
            np.testing.assert_array_equal(seq[k], outs[0][k])
        got[pkg] = outs[0]
    _close(got['torch'], got['jax'])


def test_reader_fed_run_eval_multi_partial_tail_then_eof_like_jax():
    """A stream ending mid-block evaluates the shorter tail; the next call
    raises EOFException."""
    got = {}
    for pkg, (fluid, m, exe, scope) in _both(
            _reader_prog, _batches(5, seed=12), train=False).items():
        with fluid.scope_guard(scope):
            m['rd'].start()
            first = exe.run_eval_multi(m['prog'], reader=m['rd'],
                                       fetch_list=[m['pred']], steps=3)
            tail = exe.run_eval_multi(m['prog'], reader=m['rd'],
                                      fetch_list=[m['pred']], steps=3)
            with pytest.raises(fluid.core.EOFException):
                exe.run_eval_multi(m['prog'], reader=m['rd'],
                                   fetch_list=[m['pred']], steps=3)
        got[pkg] = (first[0], tail[0])
    assert got['torch'][0].shape[0] == 3 and got['torch'][1].shape[0] == 2
    for i in range(2):
        _close(got['torch'][i], got['jax'][i])


def test_reader_fed_run_eval_multi_splits_at_bucket_boundary_like_jax():
    """The eval drain pushes a ragged tail back: it is evaluated as its
    own shorter dispatch."""
    rng = np.random.RandomState(13)
    batches = [(rng.rand(8, 4).astype('float32'),
                rng.randint(0, 3, (8, 1)).astype('int64'))
               for _ in range(2)]
    batches.append((rng.rand(5, 4).astype('float32'),
                     rng.randint(0, 3, (5, 1)).astype('int64')))
    got = {}
    for pkg, (fluid, m, exe, scope) in _both(_reader_prog, batches,
                                             train=False).items():
        with fluid.scope_guard(scope):
            m['rd'].start()
            outs = exe.run_eval_multi(m['prog'], reader=m['rd'],
                                      fetch_list=[m['pred']], steps=3)
            tail = exe.run_eval_multi(m['prog'], reader=m['rd'],
                                      fetch_list=[m['pred']], steps=3)
        got[pkg] = (outs[0], np.asarray(tail[0]))
    assert got['torch'][0].shape == (2, 8, 3)
    assert np.shape(got['torch'][1])[1] == 5
    for i in range(2):
        _close(got['torch'][i], got['jax'][i])


def test_run_eval_multi_plain_feed_error_names_its_own_reader_mode_like_jax():
    """The plain-feed refusal on a reader-fed program names
    run_eval_multi's own reader= mode; reader= with feed= is refused."""
    raised = {}
    for pkg, (fluid, m, exe, scope) in _both(_reader_prog, _batches(2),
                                             train=False).items():
        with fluid.scope_guard(scope):
            raised[pkg] = [
                _raised(lambda: exe.run_eval_multi(
                    m['prog'], feed={}, fetch_list=[m['pred']], steps=2)),
                _raised(lambda: exe.run_eval_multi(
                    m['prog'], reader=m['rd'], feed={},
                    fetch_list=[m['pred']], steps=2))]
    assert raised['torch'] == raised['jax']
    assert 'run_eval_multi(reader=' in raised['torch'][0][1]
    assert raised['torch'][1][0] == 'ValueError'


# ---- the pipelined Trainer loop -------------------------------------------

def _trainer_func(fluid):
    def train_func():
        x = fluid.layers.data('x', [4])
        label = fluid.layers.data('label', [1], dtype='int64')
        pred = fluid.layers.fc(x, 3, act='softmax')
        return [fluid.layers.mean(fluid.layers.cross_entropy(pred, label))]
    return train_func


def test_trainer_pipelined_loop_matches_plain_like_jax():
    """Trainer.train(steps_per_dispatch=K) rides the FeedPipeline: the
    losses at the dispatch boundaries equal the plain loop's (bitwise in
    each package), the events fire as in the JAX package, and the port's
    losses equal the JAX package's from the same start."""
    rng = np.random.RandomState(0)
    data = [[(rng.rand(4).astype('float32'), int(rng.randint(0, 3)))
             for _ in range(8)] for _ in range(4)]
    start = None
    runs = {}
    for pkg, fluid in PKGS:
        for spd in (1, 2):
            losses, events = [], []

            def handler(e):
                events.append(type(e).__name__)
                if isinstance(e, fluid.EndStepEvent):
                    losses.append(float(np.asarray(e.metrics[0])
                                        .reshape(-1)[0]))

            with fluid.unique_name.guard():
                tr = fluid.Trainer(_trainer_func(fluid),
                                   lambda: fluid.optimizer.SGD(0.5),
                                   place=fluid.CPUPlace())
            if start is None:
                start = _state(pkg, tr.train_program, tr.scope)
            for name, arr in start.items():
                if pkg == 'torch':
                    tr.scope.var(name).set_value(torch.tensor(arr))
            tr.train(2, handler, reader=lambda: iter(data),
                     feed_order=['x', 'label'], steps_per_dispatch=spd)
            runs[pkg, spd] = (losses, events)
    for pkg, _ in PKGS:
        plain, piped = runs[pkg, 1][0], runs[pkg, 2][0]
        assert len(piped) == 4
        np.testing.assert_array_equal(plain[1::2], piped)
    assert runs['torch', 2][1] == runs['jax', 2][1]
    assert runs['torch', 2][1].count('BeginStepEvent') == 4
    _close(runs['torch', 1][0], runs['jax', 1][0])


def test_pipeline_delivery_rebuilds_sparse_and_array_fetches():
    """A dispatch's fetches go to the host as one flat list of tensors
    (``HostCopy``, which on the card waits for its own event only) and are
    rebuilt in their structure on delivery: a tensor, a sparse gradient's
    rows and values, a tensor array's elements."""
    from paddle_tpu_torch.fluid import dataflow
    from paddle_tpu_torch.fluid.executor import HostCopy
    from paddle_tpu_torch.ops.sparse import SparseRows
    g = torch.Generator().manual_seed(0)
    fetches = [torch.randn(3, generator=g),
               SparseRows(torch.tensor([2, 0]),
                          torch.randn(2, 4, generator=g), 5),
               [torch.randn(2, generator=g), torch.randn(2, generator=g)]]
    leaves = []
    for f in fetches:
        dataflow._fetch_leaves(f, leaves)
    assert len(leaves) == 5
    copy = HostCopy(leaves)
    assert copy.done()  # on the CPU the tensors are already there
    it = iter(copy.tensors())
    back = [dataflow._with_leaves(f, it) for f in fetches]
    assert next(it, None) is None
    assert torch.equal(back[0], fetches[0])
    assert isinstance(back[1], SparseRows) and back[1].height == 5
    assert torch.equal(back[1].rows, fetches[1].rows)
    assert torch.equal(back[1].values, fetches[1].values)
    assert [torch.equal(a, b) for a, b in zip(back[2], fetches[2])] == \
        [True, True]


# ---- two serving engines on one executor ------------------------------------

def test_two_engines_on_one_executor_each_get_their_own_results():
    """Two InferenceEngines with no registry (no dispatch gate) on one
    executor, one scope and one program, fed from two threads with
    distinct requests while the interpreter switches threads every
    microsecond: every response equals the same request served alone.
    The executor's lock, which serializes each dispatch's feed copy,
    replay and copy-out on the card, is taken on this path too."""
    from paddle_tpu_torch import serving
    fluid = tfluid
    m = _data_prog(fluid)
    test = fluid.io.get_inference_program([m['pred']], m['prog'])
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.core.Scope()
    exe.run(m['startup'], scope=scope)
    taken = []

    class CountingLock(object):
        """The executor's lock, noting each thread that takes it."""

        def __init__(self):
            self._lock = threading.RLock()

        def __enter__(self):
            self._lock.acquire()
            taken.append(threading.get_ident())

        def __exit__(self, *exc):
            self._lock.release()

    exe._run_lock = CountingLock()  # the blocks resolved from here on
    rng = np.random.RandomState(5)
    reqs = [[{'x': rng.rand(4, 4).astype('float32')} for _ in range(40)]
            for _ in range(2)]
    config = serving.ServingConfig(max_batch_size=4, bucket_sizes=[4],
                                   steps_per_dispatch=4, pipeline_depth=2)
    engines = [serving.InferenceEngine(
        test, feed_names=['x'], fetch_list=[m['pred']], scope=scope,
        executor=exe, place=fluid.CPUPlace(), config=config,
        name='two-%d' % i) for i in range(2)]
    for eng in engines:
        eng.start()
    try:
        alone = [[eng.submit(r).result(60)[0] for r in rs]
                 for eng, rs in zip(engines, reqs)]
        del taken[:]
        got = [None, None]

        def serve(i):
            futs = [engines[i].submit(r) for r in reqs[i]]
            got[i] = [f.result(60)[0] for f in futs]

        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=serve, args=(i, ))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        finally:
            sys.setswitchinterval(switch)
        assert not any(t.is_alive() for t in threads)
    finally:
        for eng in engines:
            eng.stop()
    blocks = [c for c in exe.cached_blocks() if c.program is test]
    assert len(blocks) == 1  # one block: the two engines share it
    assert len(set(taken)) == 2  # both workers went through the lock
    for i in range(2):
        for k in range(len(reqs[i])):
            np.testing.assert_allclose(got[i][k], alone[i][k], rtol=2e-6,
                                       atol=0)
