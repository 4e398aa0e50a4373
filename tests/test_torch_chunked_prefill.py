"""The PyTorch port's chunked prefill held against the JAX package on the
CPU: both families' chunk programs chained over a prompt against the
monolithic prefill, the engine's chunk lane against the monolithic lane,
per-request reference decode and the JAX engine (depths 1 and 2, inline
and started), the prefilling slot phase through eviction and shedding,
and the typed rejects.  Each case mirrors one of
``tests/test_chunked_prefill.py`` (the mesh one excepted).

Tolerances: tokens exactly equal to the JAX package's; the chained
chunks' hidden and K/V rows against the monolithic prefill's within atol
1e-6 (``CHAIN_TOL``): the port's GRU is not bitwise here, because torch's
CPU GEMM picks its kernel by the row count, and a chunk runs the slot
batch where the prefill runs one row (the largest difference measured is
printed by ``test_nmt_chunk_chain_matches_prefill``); the K/V rows of the
Transformer family are bitwise (each row is one token's projection).
States against the JAX package's: rtol 1e-5, atol 1e-6.
"""

import time

import numpy as np
import pytest

from paddle_tpu.fluid import unique_name as jax_unique_name

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import serving as tserving

from test_torch_generation import (
    DIM, FLUID, PKGS, SERVING, STATE_TOL, V_SRC, assert_counts_equal,
    build_pair, deferred_generate, nmt_feed, nmt_ids, reference_decode,
    tf_feed, tf_ids)

CHUNK = 16
MAX_CTX = 32
CHAIN_TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(autouse=True)
def _own_names():
    with jax_unique_name.guard(), tfluid.unique_name.guard():
        yield


@pytest.fixture(scope='module')
def nmt_chunk():
    return build_pair('nmt', chunk=CHUNK)


@pytest.fixture(scope='module')
def tf_chunk():
    return build_pair('tf', chunk=CHUNK, max_ctx=MAX_CTX)


def chain_chunks(pkg, pair, carry, flat, length, slot, budget):
    """Drive the raw chunk dispatch over one prompt in CHUNK blocks."""
    m, exe, scope = pair[pkg]
    c = m['chunk_width']
    s = np.shape(carry['token'])[0]
    chunk_arg = {'token': m['chunk_token'], 'len': m.get('chunk_len'),
                 'state': m['chunk_state'], 'start_id': m['start_id']}
    cursor = 0
    while cursor < length:
        n = min(c, length - cursor)
        blk = np.zeros((s, c, 1), np.int64)
        blk[slot, :n, 0] = flat[cursor:cursor + n]
        lens = np.zeros((s, ), np.int32)
        lens[slot] = n
        feed = {'gen_ctok': blk, 'gen_ctok@SEQLEN': lens}
        if m.get('chunk_len'):
            feed[m['chunk_len']] = lens.astype('float32')[:, None]
        aux = {'active': lens > 0,
               'finish': np.arange(s) == (
                   slot if cursor + n >= length else -1),
               'budget': np.full((s, ), budget, np.int32)}
        carry, _, _ = exe._dispatch_chunk_prefill(
            m['chunk'], feed=feed, carry=carry, aux=aux, chunk=chunk_arg,
            scope=scope)
        cursor += n
    return carry


def _host(carry):
    return {'slots': {n: np.asarray(v) for n, v in carry['slots'].items()},
            'token': np.asarray(carry['token']),
            'alive': np.asarray(carry['alive']),
            'remaining': np.asarray(carry['remaining'])}


# ---- the chunk programs chained --------------------------------------------

def test_nmt_chunk_chain_matches_prefill(nmt_chunk):
    """Chained GRU chunks (37 tokens: 3 chunks, a ragged tail) against the
    monolithic prefill (CHAIN_TOL) and the JAX package's chain
    (STATE_TOL); the inactive slot's slab untouched, the finishing chunk
    flipping the carry to decoding; the compile counts of the JAX
    package's."""
    rng = np.random.RandomState(0)
    length = 37
    ids = rng.randint(2, V_SRC, size=(length, 1)).astype('int64')
    out = {}
    for pkg in PKGS:
        m, exe, scope = nmt_chunk[pkg]
        boot, = exe.run(m['prefill'], feed=nmt_feed(pkg, ids),
                        fetch_list=m['prefill_fetches'], scope=scope)
        carry = {'slots': {'gen_hidden': np.zeros((2, DIM), 'float32')},
                 'token': np.full((2, 1), m['end_id'], np.int64),
                 'alive': np.zeros((2, ), bool),
                 'remaining': np.zeros((2, ), np.int32)}
        c0 = exe.compile_count
        carry = _host(chain_chunks(pkg, nmt_chunk, carry, ids.reshape(-1),
                                   length, slot=0, budget=7))
        out[pkg] = (np.asarray(boot), carry, exe.compile_count - c0)
    boot, carry, compiles = out['torch']
    h = carry['slots']['gen_hidden']
    diff = float(np.abs(h[0] - boot[0]).max())
    print('chained chunks against the prefill: max |diff| %.3g%s' %
          (diff, ' (bitwise)' if diff == 0 else ''))
    np.testing.assert_allclose(h[0], boot[0], **CHAIN_TOL)
    np.testing.assert_array_equal(h[1], np.zeros(DIM, 'float32'))
    assert carry['alive'].tolist() == [True, False]
    assert int(carry['token'][0, 0]) == nmt_chunk['torch'][0]['start_id']
    assert int(carry['remaining'][0]) == 7
    np.testing.assert_allclose(h, out['jax'][1]['slots']['gen_hidden'],
                               **STATE_TOL)
    assert compiles == out['jax'][2]


def test_tf_chunk_chain_writes_exact_kv(tf_chunk):
    """Chained Transformer chunks write exactly the prompt's K/V rows
    (bitwise against the monolithic projections) and advance the
    position; rows past the prompt stay zero; against the JAX package's
    chain within STATE_TOL."""
    rng = np.random.RandomState(1)
    length = 21
    ids = tf_ids(rng, length)
    out = {}
    for pkg in PKGS:
        m, exe, scope = tf_chunk[pkg]
        k0, v0, _ = exe.run(m['prefill'], feed=tf_feed(pkg, ids),
                            fetch_list=m['prefill_fetches'], scope=scope)
        carry = {'slots': {'gen_k': np.zeros((2, MAX_CTX, 8), 'float32'),
                           'gen_v': np.zeros((2, MAX_CTX, 8), 'float32'),
                           'gen_pos': np.zeros((2, 1), 'float32')},
                 'token': np.full((2, 1), m['end_id'], np.int64),
                 'alive': np.zeros((2, ), bool),
                 'remaining': np.zeros((2, ), np.int32)}
        carry = _host(chain_chunks(pkg, tf_chunk, carry, ids.reshape(-1),
                                   length, slot=0, budget=6))
        out[pkg] = (np.asarray(k0), np.asarray(v0), carry)
    k0, v0, carry = out['torch']
    k, v = carry['slots']['gen_k'], carry['slots']['gen_v']
    pos = carry['slots']['gen_pos']
    np.testing.assert_array_equal(k[0, :length], k0[0])
    np.testing.assert_array_equal(v[0, :length], v0[0])
    np.testing.assert_array_equal(
        k[0, length:], np.zeros((MAX_CTX - length, 8), 'float32'))
    assert pos[0, 0] == length and pos[1, 0] == 0
    for name in ('gen_k', 'gen_v', 'gen_pos'):
        np.testing.assert_allclose(carry['slots'][name],
                                   out['jax'][2]['slots'][name],
                                   **STATE_TOL)


# ---- the engine's chunk lane -----------------------------------------------

def _engine(pkg, pair, name, chunk=None, depth=2, slots=4, executor=None,
            **cfg):
    m, exe, scope = pair[pkg]
    serving, fluid = SERVING[pkg], FLUID[pkg]
    return serving.InferenceEngine(
        m['prefill'], fetch_list=m['prefill_fetches'], scope=scope,
        executor=executor if executor is not None else exe,
        place=fluid.CPUPlace(),
        config=serving.ServingConfig(
            max_batch_size=8, max_wait_ms=2, decode_slots=slots,
            decode_steps=3, decode_pipeline_depth=depth,
            prefill_chunk=chunk, **cfg),
        generation=serving.GenerationSpec.from_model(m), name=name)


@pytest.mark.parametrize('depth', [1, 2])
def test_chunked_engine_token_identical_across_depths(nmt_chunk, depth):
    """Chunked prefill token-identical to the monolithic lane and to
    per-request reference decode (the JAX package's) over a mixed
    short/long stream; chunk dispatches really happened, no prefill lot
    formed on the chunked lane."""
    rng = np.random.RandomState(2)
    lens = [3, 40, 9, 25, 5, 33]
    ids = [nmt_ids(rng, n) for n in lens]
    max_lens = [7 + (i % 3) for i in range(len(ids))]
    refs = [reference_decode('jax', nmt_chunk, nmt_feed('jax', i), n)[0]
            for i, n in zip(ids, max_lens)]
    spec = tserving.GenerationSpec.from_model(nmt_chunk['torch'][0])
    assert spec.supports_chunked_prefill
    for mode in (None, CHUNK):
        eng = _engine('torch', nmt_chunk, 'ck-%s-d%d' % (mode, depth),
                      chunk=mode, depth=depth)
        with eng:
            futs = [eng.submit_generate(nmt_feed('torch', i), max_len=n)
                    for i, n in zip(ids, max_lens)]
            got = [[int(t) for t in f.result(120)] for f in futs]
        assert got == refs, mode
        md = eng.metrics()['decode']
        if mode is None:
            assert md['prefill_chunks'] == 0
            assert md['prefill_lots'] > 0
        else:
            assert md['prefill_chunks'] >= 2
            assert md['prefill_lots'] == 0
            assert md['prefill_chunk_tokens'] == sum(lens)


@pytest.mark.parametrize('kind,depth', [('nmt', 1), ('nmt', 2), ('tf', 2)])
def test_chunked_engine_counts_match_jax(nmt_chunk, tf_chunk, kind, depth):
    """A deterministic inline stream through the chunk lane: tokens, the
    engine's counts and every decode count (chunks, chunk tokens, syncs,
    executables) equal to the JAX engine's."""
    pair = nmt_chunk if kind == 'nmt' else tf_chunk
    rng = np.random.RandomState(30 + depth)
    if kind == 'nmt':
        ids = [nmt_ids(rng, n) for n in (3, 40, 9, 25)]
        feed = nmt_feed
    else:
        ids = [tf_ids(rng, n) for n in (3, 21, 5, 14)]
        feed = tf_feed
    res = {}
    for pkg in PKGS:
        fluid = FLUID[pkg]
        eng = _engine(pkg, pair, 'ck-counts-%s-%s-%d' % (kind, pkg, depth),
                      chunk=CHUNK, depth=depth, slots=2,
                      executor=fluid.Executor(fluid.CPUPlace()))
        res[pkg] = deferred_generate(eng, [feed(pkg, i) for i in ids],
                                     [5] * len(ids))
        eng.stop()
    assert res['torch'][0] == res['jax'][0]
    assert_counts_equal(res['jax'][1], res['torch'][1])


def test_chunked_engine_bounded_executables(nmt_chunk):
    """New prompt lengths compile nothing new on the chunk lane: the block
    shape is fixed at [S, C, 1]."""
    rng = np.random.RandomState(3)
    own = tfluid.Executor(tfluid.CPUPlace())
    eng = _engine('torch', nmt_chunk, 'ck-bound', chunk=CHUNK, executor=own)
    with eng:
        ids = nmt_ids(rng, 20)
        want = reference_decode('jax', nmt_chunk, nmt_feed('jax', ids),
                                4)[0]
        assert [int(t) for t in eng.submit_generate(
            nmt_feed('torch', ids), max_len=4).result(120)] == want
        warm = eng.metrics()['executor_compile_count']
        for n in (7, 23, 39):
            ids = nmt_ids(rng, n)
            want = reference_decode('jax', nmt_chunk, nmt_feed('jax', ids),
                                    4)[0]
            assert [int(t) for t in eng.submit_generate(
                nmt_feed('torch', ids), max_len=4).result(120)] == want
        assert eng.metrics()['executor_compile_count'] == warm


def test_chunked_engine_inline_mode(nmt_chunk):
    """A never-started chunked engine drains the chunk lane on the
    submitter's thread."""
    rng = np.random.RandomState(4)
    ids = [nmt_ids(rng, n) for n in (30, 5)]
    refs = [reference_decode('jax', nmt_chunk, nmt_feed('jax', i), 8)[0]
            for i in ids]
    eng = _engine('torch', nmt_chunk, 'ck-inline', chunk=CHUNK, slots=2)
    outs = [[int(t) for t in eng.generate(nmt_feed('torch', i), max_len=8,
                                          timeout=120)] for i in ids]
    eng.stop()
    assert outs == refs


def test_chunked_engine_transformer_kv(tf_chunk):
    """The KV-cache family through the chunk lane: partial KV accumulates
    across chunk dispatches in the slab; tokens equal to the JAX
    package's reference decode."""
    rng = np.random.RandomState(5)
    ids = [tf_ids(rng, n) for n in (3, 21, 5, 14)]
    refs = [reference_decode('jax', tf_chunk, tf_feed('jax', i),
                             tf_chunk['jax'][0]['max_len'])[0] for i in ids]
    eng = _engine('torch', tf_chunk, 'ck-tf', chunk=CHUNK, slots=2)
    with eng:
        futs = [eng.submit_generate(tf_feed('torch', i)) for i in ids]
        outs = [[int(t) for t in f.result(120)] for f in futs]
    assert outs == refs
    assert eng.metrics()['decode']['prefill_chunks'] >= 2


def test_evict_mid_prefill_resumes(nmt_chunk):
    """Eviction racing a chunked prefill: the paused window flushes the
    chain, the slabs (partial prefill state) go to host arrays bit for
    bit, the next chunk dispatch stages them back; tokens stay the JAX
    package's."""
    rng = np.random.RandomState(7)
    ids = [nmt_ids(rng, n) for n in (40, 33, 6)]
    refs = [reference_decode('jax', nmt_chunk, nmt_feed('jax', i), 8)[0]
            for i in ids]
    eng = _engine('torch', nmt_chunk, 'ck-evict', chunk=CHUNK,
                  slots=2).start()
    futs = [eng.submit_generate(nmt_feed('torch', i), max_len=8)
            for i in ids]
    deadline = time.time() + 20
    while time.time() < deadline:
        if eng._decode_cache.snapshot()['prefilling'] > 0:
            break
        time.sleep(0.001)
    moved = eng.evict_decode_cache()
    assert moved > 0
    outs = [[int(t) for t in f.result(120)] for f in futs]
    eng.stop()
    assert outs == refs


def test_evict_between_chunks_is_bitwise(nmt_chunk):
    """Deterministically mid-prefill: one chunk dispatched, the cache
    evicted, the rest chained: the final hidden bitwise equal to the
    chain that was never evicted."""
    rng = np.random.RandomState(71)
    length = 40
    ids = nmt_ids(rng, length)
    m, exe, scope = nmt_chunk['torch']
    spec = tserving.GenerationSpec.from_model(m)
    finals = []
    for evict in (False, True):
        cache = tserving.decode.SlotStateCache(spec, 2)
        req = tserving.decode.GenerationRequest(None, 1, ('gen-chunk', ),
                                                max_len=4)
        cache.admit_prefilling(req)
        flat = ids.reshape(-1)
        for cursor in range(0, length, CHUNK):
            carry = chain_chunks('torch', nmt_chunk, cache.carry(),
                                 flat[cursor:], min(CHUNK, length - cursor),
                                 slot=0, budget=4)
            cache.set_carry(carry)
            if evict and cursor == 0:
                assert cache.to_host() > 0
                assert isinstance(cache.carry()['slots']['gen_hidden'],
                                  np.ndarray)
        finals.append(np.asarray(cache.carry()['slots']['gen_hidden']))
    np.testing.assert_array_equal(finals[1], finals[0])


def test_shed_during_chunked_prefill(nmt_chunk):
    """A deadlined prompt expiring mid-prefill sheds typed, frees its
    prefilling slot, and the engine keeps serving the JAX package's
    tokens."""
    rng = np.random.RandomState(8)
    eng = _engine('torch', nmt_chunk, 'ck-shed', chunk=CHUNK,
                  slots=2).start()
    doomed = eng.submit_generate(nmt_feed('torch', nmt_ids(rng, 40)),
                                 max_len=8, deadline_ms=0.001)
    with pytest.raises(tserving.DeadlineExceededError):
        doomed.result(60)
    ids = nmt_ids(rng, 20)
    want = reference_decode('jax', nmt_chunk, nmt_feed('jax', ids), 6)[0]
    out = [int(t) for t in eng.submit_generate(
        nmt_feed('torch', ids), max_len=6).result(120)]
    eng.stop()
    assert out == want
    assert eng.metrics()['shed'] >= 1
    assert eng._decode_cache.snapshot()['prefilling'] == 0


def test_stall_metrics_reported(nmt_chunk):
    """The decode block reports the chunk lane's counters and the stall
    gauge, as the JAX engine's does (ceil(25 / 16) = 2 chunks)."""
    rng = np.random.RandomState(9)
    ids = nmt_ids(rng, 25)
    mds = {}
    for pkg in PKGS:
        eng = _engine(pkg, nmt_chunk, 'ck-metrics-' + pkg, chunk=CHUNK)
        with eng:
            eng.submit_generate(nmt_feed(pkg, ids), max_len=6).result(120)
        mds[pkg] = eng.metrics()['decode']
    for field in ('prefill_chunks', 'prefill_chunk_tokens',
                  'max_decode_stall_cycles', 'max_decode_stall_s'):
        assert field in mds['torch']
    assert set(mds['torch']) == set(mds['jax'])
    for field in ('prefill_chunks', 'prefill_chunk_tokens', 'tokens',
                  'finished'):
        assert mds['torch'][field] == mds['jax'][field], field
    assert mds['torch']['prefill_chunks'] == 2
    assert mds['torch']['prefill_chunk_tokens'] == 25


# ---- the prefilling slot phase ---------------------------------------------

def test_slot_cache_prefilling_phase(nmt_chunk):
    """admit_prefilling zeroes the slot, keeps it inert and tracks the
    cursor; finish_prefill leaves the phase; release clears it; the
    snapshots equal the JAX cache's at every step."""
    snaps = {}
    for pkg in PKGS:
        serving = SERVING[pkg]
        spec = serving.GenerationSpec.from_model(nmt_chunk[pkg][0])
        cache = serving.decode.SlotStateCache(spec, 2)
        req = serving.decode.GenerationRequest(
            {'x': np.zeros((1, 2))}, 1, ('gen', ), max_len=4)
        seen = []
        idx = cache.admit_prefilling(req)
        assert req.prefilling and req.slot == idx
        seen.append(cache.snapshot()['prefilling'])
        assert cache.prefilling_items() == [(idx, req, 0)]
        assert not cache.carry()['alive'][idx]
        assert cache.advance_prefill(idx, 16) == 16
        assert cache.prefilling_items() == [(idx, req, 16)]
        cache.finish_prefill(idx)
        assert not req.prefilling
        seen.append(cache.snapshot()['prefilling'])
        cache.release(idx)
        seen.append(cache.free_slots())
        req2 = serving.decode.GenerationRequest(
            {'x': np.zeros((1, 2))}, 1, ('gen', ), max_len=4)
        idx2 = cache.admit_prefilling(req2)
        cache.release(idx2)
        seen.append(cache.snapshot()['prefilling'])
        seen.append(cache.nbytes())
        snaps[pkg] = seen
    assert snaps['torch'] == snaps['jax'] == [1, 0, 2, 0, snaps['jax'][-1]]


# ---- validation and typed rejects ------------------------------------------

CONFIG_CASES = ['rung', 'zero', 'no_generation', 'no_chunk_program',
                'width_mismatch']


@pytest.mark.parametrize('case', CONFIG_CASES)
def test_prefill_chunk_config_validation(nmt_chunk, case):
    for pkg in PKGS:
        m, exe, scope = nmt_chunk[pkg]
        serving, fluid = SERVING[pkg], FLUID[pkg]
        spec = serving.GenerationSpec.from_model(m)
        if case == 'rung':
            assert serving.ServingConfig(prefill_chunk=20).prefill_chunk \
                == 32
        elif case == 'zero':
            with pytest.raises(ValueError, match='prefill_chunk must be'):
                serving.ServingConfig(prefill_chunk=0)
        elif case == 'no_generation':
            with pytest.raises(ValueError, match='generation'):
                serving.InferenceEngine(
                    m['prefill'], fetch_list=m['prefill_fetches'],
                    scope=scope, executor=exe, place=fluid.CPUPlace(),
                    config=serving.ServingConfig(prefill_chunk=CHUNK),
                    name='ck-nogen')
        elif case == 'no_chunk_program':
            plain = build_pair('nmt')[pkg][0]
            pspec = serving.GenerationSpec.from_model(plain)
            assert not pspec.supports_chunked_prefill
            with pytest.raises(ValueError, match='chunk program'):
                serving.InferenceEngine(
                    plain['prefill'], fetch_list=plain['prefill_fetches'],
                    scope=scope, executor=exe, place=fluid.CPUPlace(),
                    config=serving.ServingConfig(prefill_chunk=CHUNK),
                    generation=pspec, name='ck-nochunk')
        else:
            with pytest.raises(ValueError, match='chunk width'):
                serving.InferenceEngine(
                    m['prefill'], fetch_list=m['prefill_fetches'],
                    scope=scope, executor=exe, place=fluid.CPUPlace(),
                    config=serving.ServingConfig(prefill_chunk=2 * CHUNK),
                    generation=spec, name='ck-mismatch')


def test_empty_prompt_typed_reject_when_chunking(nmt_chunk):
    """A zero-length prompt rejects typed at submit under chunked prefill
    (no chunk would ever finish it); the engine serves on."""
    eng = _engine('torch', nmt_chunk, 'ck-empty', chunk=CHUNK, slots=2)
    empty = tfluid.create_lod_tensor(np.zeros((0, 1), 'int64'), [[0]],
                                     tfluid.CPUPlace())
    with pytest.raises(ValueError, match='empty'):
        eng.submit_generate({'src_word_id': empty})
    rng = np.random.RandomState(15)
    ids = nmt_ids(rng, 5)
    want = reference_decode('jax', nmt_chunk, nmt_feed('jax', ids), 4)[0]
    assert [int(t) for t in eng.generate(nmt_feed('torch', ids), max_len=4,
                                         timeout=120)] == want
    eng.stop()


SPEC_CASES = [('prompt_feed', dict(prompt_feed=None)),
              ('chunk_token', dict(chunk_token=None)),
              ('ladder rung', dict(chunk_width=CHUNK + 3)),
              ('exactly the decode state', 'bogus')]


@pytest.mark.parametrize('case', range(len(SPEC_CASES)))
def test_generation_spec_chunk_validation(nmt_chunk, case):
    match, kw = SPEC_CASES[case]
    for pkg in PKGS:
        m = nmt_chunk[pkg][0]
        base = dict(prompt_feed='src_word_id', chunk_program=m['chunk'],
                    chunk_token='gen_ctok', chunk_state=m['chunk_state'],
                    chunk_width=CHUNK)
        if kw == 'bogus':
            base['chunk_state'] = [('bogus', m['chunk_state'][0][1])]
        else:
            base.update(kw)
        with pytest.raises(ValueError, match=match):
            SERVING[pkg].GenerationSpec(
                m['prefill'], m['step'], m['prefill_feeds'],
                m['prefill_fetches'], 'gen_token', m['logits'], m['state'],
                **base)


@pytest.mark.parametrize('chunk', [None, CHUNK])
def test_over_length_prompt_typed_reject_both_families(tf_chunk, nmt_chunk,
                                                      chunk):
    """A prompt (or prompt + budget) past max_ctx is a typed ValueError at
    submit for the KV-cache family; the recurrent family has no bound and
    takes a 60-token prompt."""
    rng = np.random.RandomState(10)
    spec = tserving.GenerationSpec.from_model(tf_chunk['torch'][0])
    assert spec.max_ctx == MAX_CTX
    eng = _engine('torch', tf_chunk, 'ck-rej-%s' % chunk, chunk=chunk,
                  slots=2)
    with pytest.raises(ValueError, match='max_ctx'):
        eng.submit_generate(tf_feed('torch', tf_ids(rng, 40)))
    with pytest.raises(ValueError, match='max_len'):
        eng.submit_generate(tf_feed('torch', tf_ids(rng, 28)), max_len=6)
    ok = tf_ids(rng, 5)
    want = reference_decode('jax', tf_chunk, tf_feed('jax', ok), 4)[0]
    assert [int(t) for t in eng.generate(tf_feed('torch', ok), max_len=4,
                                         timeout=120)] == want
    eng.stop()
    nspec = tserving.GenerationSpec.from_model(nmt_chunk['torch'][0])
    assert nspec.max_ctx is None
    eng = _engine('torch', nmt_chunk, 'ck-rej-nmt-%s' % chunk, chunk=chunk,
                  slots=2)
    ids = nmt_ids(rng, 60)
    want = reference_decode('jax', nmt_chunk, nmt_feed('jax', ids), 5)[0]
    assert [int(t) for t in eng.generate(nmt_feed('torch', ids), max_len=5,
                                         timeout=120)] == want
    eng.stop()


def test_decode_and_chunk_costs_under_cost_accounting(nmt_chunk):
    """Under FLAGS_cost_accounting the decode loop's block carries
    ``last_decode_cost`` (kind 'decode_multi', K steps of the step
    program's FLOPs) and the chunk block ``last_chunk_cost``; both land in
    ``cost_report``."""
    m, _, scope = nmt_chunk['torch']
    exe = tfluid.Executor(tfluid.CPUPlace())
    tfluid.FLAGS.cost_accounting = True
    try:
        carry = {'slots': {'gen_hidden': np.zeros((2, DIM), 'float32')},
                 'token': np.zeros((2, 1), np.int64),
                 'alive': np.ones((2, ), bool),
                 'remaining': np.full((2, ), 5, np.int32)}
        spec = tserving.GenerationSpec.from_model(m)
        _, _, _, block = exe._dispatch_decode_multi(
            m['step'], carry=carry, steps=3, decode=spec.decode_arg(),
            scope=scope)
        cost = block.last_decode_cost
        assert cost['kind'] == 'decode_multi' and cost['steps'] == 3
        assert cost['flops'] == 3 * cost['flops_per_step'] > 0
        blk = np.zeros((2, CHUNK, 1), np.int64)
        lens = np.array([CHUNK, 0], np.int32)
        _, _, cblock = exe._dispatch_chunk_prefill(
            m['chunk'], feed={'gen_ctok': blk, 'gen_ctok@SEQLEN': lens},
            carry=carry, aux={'active': lens > 0,
                              'finish': np.zeros(2, bool),
                              'budget': np.zeros(2, np.int32)},
            chunk=spec.chunk_arg(), scope=scope)
        ccost = cblock.last_chunk_cost
        assert ccost['kind'] == 'chunk_prefill' and ccost['flops'] > 0
        kinds = {e['kind'] for e in exe.cost_report()}
        assert {'decode_multi', 'chunk_prefill'} <= kinds
    finally:
        tfluid.FLAGS.cost_accounting = False
