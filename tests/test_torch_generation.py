"""The PyTorch port's generation serving held against the JAX package on
the CPU (``CPUPlace()``): the five lowerings the step-decode models add
(``matmul``, ``one_hot``, ``expand``, ``sequence_mask``, ``gru``), one-op
with their generic grads; both ``build_step_decode`` programs; the
executor's ``run_decode_multi``; ``GenerationSpec``, ``SlotStateCache``
and ``InferenceEngine(generation=)`` inline and started, at
``decode_pipeline_depth`` 1 and 2; ``ModelRegistry.load(generation=)``
with its ``:decode-cache`` account.  Each case mirrors one of
``tests/test_generation_serving.py`` (the mesh ones excepted): the same
seeded prompts go to both packages' models, the port's scope holding the
JAX package's startup parameters.

Tolerances: generated tokens exactly equal to the JAX package's (both
greedy decodes of the same f32 arithmetic, up to summation order);
hidden and KV states rtol 1e-5, atol 1e-6; one-op outputs and gradients
1e-5 (gradients scaled by max(1, max|g|)).  Compile counts are held equal
to the JAX package's where the lots form deterministically: inline
engines whose queue drains in one pass (``_deferred``) and executor
calls.  The JAX package holds tokens as int32 (x64 off), the port as
int64: values are compared.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.models import seq2seq as jseq2seq
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.serving.arbiter import program_seed_bytes as jseed

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.models import seq2seq as tseq2seq
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.serving.arbiter import program_seed_bytes as tseed

from test_torch_cv_ops import program_desc
from test_torch_nmt import _run as _one_op_run

V_SRC, V_TRG, DIM = 40, 30, 12
NMT = dict(src_dict_dim=V_SRC, trg_dict_dim=V_TRG, embedding_dim=8,
           encoder_size=DIM, decoder_size=DIM, max_len=10)
TF = dict(vocab=30, d_model=8, d_k=8, max_ctx=16, max_len=6)
TOL = 1e-5
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
PKGS = ('jax', 'torch')
FLUID = {'jax': jfluid, 'torch': tfluid}
SERVING = {'jax': jserving, 'torch': tserving}
DECODE_COUNTS = ('requests', 'finished', 'tokens', 'dispatches',
                 'prefill_lots', 'prefill_chunks', 'prefill_chunk_tokens',
                 'host_syncs', 'harvests', 'chain_flushes',
                 'steps_per_dispatch', 'tokens_per_dispatch',
                 'slot_occupancy', 'host_syncs_per_token')
ENGINE_COUNTS = ('requests', 'lots', 'dispatches', 'compiles',
                 'executor_compile_count', 'shed', 'errors')


@pytest.fixture(autouse=True)
def _own_names():
    """Each case names its vars afresh in both packages."""
    with jax_unique_name.guard(), tfluid.unique_name.guard():
        yield


# ---- the pair of models --------------------------------------------------

def build_pair(kind, chunk=None, **kwargs):
    """``build_step_decode`` of the NMT ('nmt') or Transformer ('tf')
    family in both packages: {'jax': (model, exe, scope), 'torch': ...},
    the port's scope holding the JAX package's startup parameters."""
    mods = {'nmt': (jseq2seq, tseq2seq, NMT), 'tf': (jtransformer,
                                                      ttransformer, TF)}
    jmod, tmod, widths = mods[kind]
    kw = dict(widths, chunk=chunk, **kwargs)
    with jax_unique_name.guard():
        jm = jmod.build_step_decode(**kw)
    with tfluid.unique_name.guard():
        tm = tmod.build_step_decode(**kw)
    progs = ['prefill', 'step'] + (['chunk'] if chunk else [])
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.core.Scope()
    with jfluid.scope_guard(jscope):
        for p in progs:
            jexe.run(jm[p + '_startup'])
    tscope = tfluid.core.Scope()
    for p in progs:
        arrays = {v.name: np.asarray(jscope.find_var(v.name).value())
                  for v in jm[p].all_parameters()}
        tfluid.params_from_numpy(tm[p], arrays, scope=tscope,
                                 place=tfluid.CPUPlace())
    return {'jax': (jm, jexe, jscope),
            'torch': (tm, tfluid.Executor(tfluid.CPUPlace()), tscope)}


@pytest.fixture(scope='module')
def nmt_pair():
    return build_pair('nmt')


@pytest.fixture(scope='module')
def tf_pair():
    return build_pair('tf')


def nmt_ids(rng, length):
    return rng.randint(2, V_SRC, size=(length, 1)).astype('int64')


def nmt_feed(pkg, ids):
    fluid = FLUID[pkg]
    return {'src_word_id': fluid.create_lod_tensor(
        ids.tolist(), [[len(ids)]], fluid.CPUPlace())}


def tf_ids(rng, length, vocab=TF['vocab']):
    return rng.randint(2, vocab, size=(length, 1)).astype('int64')


def tf_feed(pkg, ids):
    return {'gen_src': ids[None],
            'gen_src_len': np.array([[len(ids)]], np.float32)}


def reference_decode(pkg, pair, feed, max_len):
    """One prefill ``exe.run`` plus one step ``exe.run`` per token (the
    per-request decode the lane replaces), both families: (tokens,
    dispatches)."""
    m, exe, scope = pair[pkg]
    spec = SERVING[pkg].GenerationSpec.from_model(m)
    boot = exe.run(m['prefill'], feed=feed, fetch_list=m['prefill_fetches'],
                   scope=scope)
    state = {}
    for name, val in zip(spec.slot_feeds, boot):
        val = np.asarray(val)
        padded = np.zeros((1, ) + spec.slot_shapes[name],
                          spec.slot_dtypes[name])
        padded[tuple(slice(0, d) for d in val.shape)] = val
        state[name] = padded
    names = [n for n, _ in m['state']]
    tok, toks, n = m['start_id'], [], 1
    for _ in range(max_len):
        out = exe.run(m['step'], feed=dict(state, **{
            m['token']: np.array([[tok]], np.int64)}),
            fetch_list=[m['logits']] + [f for _, f in m['state']],
            scope=scope)
        n += 1
        tok = int(np.argmax(np.asarray(out[0]).reshape(1, -1), axis=-1)[0])
        toks.append(tok)
        if tok == m['end_id']:
            break
        state.update((k, np.asarray(v)) for k, v in zip(names, out[1:]))
    return toks, n


def engine(pkg, pair, name, executor=None, **cfg):
    m, exe, scope = pair[pkg]
    serving = SERVING[pkg]
    fluid = FLUID[pkg]
    return serving.InferenceEngine(
        m['prefill'], fetch_list=m['prefill_fetches'], scope=scope,
        executor=executor if executor is not None else exe,
        place=fluid.CPUPlace(), config=serving.ServingConfig(**cfg),
        generation=serving.GenerationSpec.from_model(m), name=name)


def deferred_generate(eng, feeds, max_lens):
    """Queue the generation requests in a never-started engine, then drain
    them in one synchronous pass: the lots form from the whole queue, the
    same way in both packages.  Returns (token lists, metrics) with the
    executor's compile count taken from the start of the stream."""
    c0 = eng._exe.compile_count
    eng._drain_inline = lambda: None
    futs = [eng.submit_generate(f, max_len=n) for f, n in zip(feeds,
                                                             max_lens)]
    del eng._drain_inline
    eng._drain_inline()
    outs = [[int(t) for t in f.result(60)] for f in futs]
    m = eng.metrics()
    m['executor_compile_count'] -= c0
    return outs, m


def assert_counts_equal(mj, mt):
    for k in ENGINE_COUNTS:
        assert mt[k] == mj[k], (k, mt[k], mj[k])
    for k in DECODE_COUNTS:
        assert mt['decode'][k] == mj['decode'][k], (k, mt['decode'][k],
                                                    mj['decode'][k])


# ---- the five lowerings, one op each ------------------------------------

def _one_op_check(case, slot=None, wrt=(), nonzero=True):
    """``case``'s op in both packages: every output, then (with ``slot``)
    the gradients of ``wrt`` under a random cotangent of that output."""
    fetch = list(case[2].values())
    want = _one_op_run(jfluid, case, fetch)
    got = _one_op_run(tfluid, case, fetch)
    for name, w, g in zip(fetch, want, got):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    if slot is None:
        return got
    shape = want[fetch.index(case[2][slot])].shape
    cot = np.random.RandomState(8).standard_normal(shape).astype('float32')
    want = _one_op_run(jfluid, case, None, cot, slot, wrt)
    grads = _one_op_run(tfluid, case, None, cot, slot, wrt)
    for name, w, g in zip(wrt, want, grads):
        assert g.shape == w.shape, name
        assert (np.abs(w).max() > 0) == nonzero, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name + '@GRAD')
    return got


MATMUL_CASES = [
    # x shape, y shape, transpose_X, transpose_Y, alpha
    ((3, 4), (4, 5), False, False, 1.0),
    ((4, 3), (4, 5), True, False, 0.5),
    ((3, 4), (5, 4), False, True, 2.0),
    ((2, 3, 4), (2, 4, 5), False, False, 1.0),
    ((2, 6, 3), (2, 6, 4), True, False, 1.0),
    ((2, 3, 4), (4, 5), False, False, 1.0),
    ((4, ), (4, 5), False, False, 1.0),
    ((3, 4), (4, ), False, False, 1.0),
]


@pytest.mark.parametrize('case', range(len(MATMUL_CASES)))
def test_matmul_matches_jax(case):
    xs, ys, tx, ty, alpha = MATMUL_CASES[case]
    rng = np.random.RandomState(case)
    x = rng.standard_normal(xs).astype('float32')
    y = rng.standard_normal(ys).astype('float32')
    _one_op_check(('matmul', {'X': ('x', x), 'Y': ('y', y)},
                   {'Out': 'out'}, {'transpose_X': tx, 'transpose_Y': ty,
                                    'alpha': alpha}),
                  slot='Out', wrt=('x', 'y'))


@pytest.mark.parametrize('times', [(1, 1, 4), (2, 3, 1), (3, 1, 2)])
def test_expand_matches_jax(times):
    x = np.random.RandomState(1).standard_normal((2, 3, 1)).astype(
        'float32')
    _one_op_check(('expand', {'X': ('x', x)}, {'Out': 'out'},
                   {'expand_times': list(times)}), slot='Out', wrt=('x', ))


@pytest.mark.parametrize('values', [
    [[0.], [3.], [7.], [2.]],          # float positions [B, 1]
    [[1., 15.], [16., 3.]],            # [B, C] block positions, one out
    [[-1.], [2.5], [5.]],              # negative and fractional: zeros
])
def test_one_hot_of_float_positions_matches_jax(values):
    """``gen_pos`` is float32: rows compare against the column index in
    X's dtype, an out-of-range or fractional value gives a zero row, and
    the generic grad is zero (no gradient flows through a comparison)."""
    x = np.asarray(values, np.float32)
    got = _one_op_check(('one_hot', {'X': ('x', x)}, {'Out': 'out'},
                         {'depth': 16}), slot='Out', wrt=('x', ),
                        nonzero=False)
    assert got[0].dtype == np.float32


def test_one_hot_of_int_ids_matches_jax():
    x = np.array([[1], [0], [4]], np.int64)
    _one_op_check(('one_hot', {'X': ('x', x)}, {'Out': 'out'},
                   {'depth': 5}))


@pytest.mark.parametrize('out_dtype', ['float32', 'int64', 'bool'])
def test_sequence_mask_matches_jax(out_dtype):
    x = np.array([[3.], [0.], [7.], [8.]], np.float32)
    _one_op_check(('sequence_mask', {'X': ('x', x)}, {'Out': 'out'},
                   {'maxlen': 8, 'out_dtype': out_dtype}))


def test_sequence_mask_needs_a_static_maxlen():
    x = np.array([[3.]], np.float32)
    with pytest.raises(NotImplementedError, match='maxlen'):
        _one_op_run(tfluid, ('sequence_mask', {'X': ('x', x)},
                             {'Out': 'out'}, {'maxlen': -1}), ['out'])


GRU_CASES = [
    # acts (gate, candidate), reverse, h0, bias, lengths
    (('sigmoid', 'tanh'), False, True, True, (3, 1, 5, 2)),
    (('sigmoid', 'tanh'), True, True, True, (4, 2, 6)),
    (('sigmoid', 'relu'), False, False, True, (2, 5)),
    (('sigmoid', 'tanh'), False, False, False, (5, 5, 5)),
]


@pytest.mark.parametrize('case', range(len(GRU_CASES)))
def test_gru_matches_jax(case):
    """The dynamic GRU over LoD rows (steps past each row's length keep
    its hidden), with H0, is_reverse, the activation attrs and the bias;
    the generic grad of Input, Weight, Bias and H0."""
    (gate, cand), reverse, h0, bias, lengths = GRU_CASES[case]
    rng = np.random.RandomState(case)
    d = 6
    inputs = {'Input': ('x', 0.5 * rng.standard_normal(
        (sum(lengths), 3 * d)).astype('float32'), lengths),
        'Weight': ('w', 0.5 * rng.standard_normal((d, 3 * d)).astype(
            'float32'))}
    wrt = ['x', 'w']
    if bias:
        inputs['Bias'] = ('b', 0.1 * rng.standard_normal(
            (1, 3 * d)).astype('float32'))
        wrt.append('b')
    if h0:
        inputs['H0'] = ('h0', rng.standard_normal(
            (len(lengths), d)).astype('float32'))
        wrt.append('h0')
    _one_op_check(('gru', inputs,
                   {'Hidden': 'hidden', 'BatchGate': 'bg',
                    'BatchResetHiddenPrev': 'brh', 'BatchHidden': 'bh'},
                   {'is_reverse': reverse, 'gate_activation': gate,
                    'activation': cand}),
                  slot='Hidden', wrt=tuple(wrt))


def test_registry_holds_the_five_lowerings():
    from paddle_tpu_torch.ops import registry as treg
    for op in ('matmul', 'one_hot', 'expand', 'sequence_mask', 'gru'):
        assert op in treg._LOWERINGS, op
    assert len(treg._LOWERINGS) == 192


# ---- the programs ---------------------------------------------------------

@pytest.mark.parametrize('kind,chunk', [('nmt', None), ('nmt', 16),
                                        ('tf', None), ('tf', 16)])
def test_build_step_decode_programs_match_jax(kind, chunk):
    pair = build_pair(kind, chunk=chunk)
    jm, tm = pair['jax'][0], pair['torch'][0]
    keys = ['prefill', 'prefill_startup', 'step', 'step_startup']
    if chunk:
        keys += ['chunk', 'chunk_startup']
        assert tm['chunk_width'] == jm['chunk_width']
    for key in keys:
        assert program_desc(tm[key]) == program_desc(jm[key]), key
    for key in ('prefill_feeds', 'token', 'start_id', 'end_id', 'max_len',
                'prompt'):
        assert tm[key] == jm[key], key
    assert [n for n, _ in tm['state']] == [n for n, _ in jm['state']]
    assert [v.name for v in tm['prefill_fetches']] == \
        [v.name for v in jm['prefill_fetches']]


def test_step_programs_match_jax_one_call(nmt_pair, tf_pair):
    """One prefill and one step call of each family on the same inputs:
    logits and every state fetch."""
    rng = np.random.RandomState(3)
    for pair, feed_of, ids in ((nmt_pair, nmt_feed, nmt_ids(rng, 7)),
                               (tf_pair, tf_feed, tf_ids(rng, 5))):
        got = {}
        for pkg in PKGS:
            m, exe, scope = pair[pkg]
            boot = exe.run(m['prefill'], feed=feed_of(pkg, ids),
                           fetch_list=m['prefill_fetches'], scope=scope)
            got[pkg] = [np.asarray(b) for b in boot]
        for w, g in zip(got['jax'], got['torch']):
            np.testing.assert_allclose(g, w, **STATE_TOL)


# ---- the executor's decode loop -------------------------------------------

def test_run_decode_multi_matches_per_slot_reference(nmt_pair):
    """K steps a dispatch over 4 slots with mixed stop conditions (EOS and
    budget) equal to a per-slot host loop over the same step program and
    to the JAX package's loop, tokens exactly, the final hidden within
    STATE_TOL; one block and one decode loop compiled, as in the JAX
    package."""
    rng = np.random.RandomState(0)
    s = 4
    h0 = rng.standard_normal((s, DIM)).astype('float32')
    budgets = np.array([5, 3, 8, 6], np.int32)
    got, hidden, compiles = {}, {}, {}
    for pkg in PKGS:
        m, exe, scope = nmt_pair[pkg]
        decode = {'token': 'gen_token', 'logits': m['logits'],
                  'state': m['state'], 'end_id': m['end_id']}
        carry = {'slots': {'gen_hidden': h0.copy()},
                 'token': np.full((s, 1), m['start_id'], np.int64),
                 'alive': np.ones((s, ), bool), 'remaining': budgets.copy()}
        toks_by_slot = [[] for _ in range(s)]
        before = exe.compile_count
        for _ in range(4):
            carry, toks, alive_in = exe.run_decode_multi(
                m['step'], carry=carry, steps=3, decode=decode,
                scope=scope)
            toks, alive_in = np.asarray(toks), np.asarray(alive_in)
            for i in range(toks.shape[0]):
                for slot in range(s):
                    if alive_in[i, slot]:
                        toks_by_slot[slot].append(int(toks[i, slot]))
            if not np.asarray(carry['alive']).any():
                break
        got[pkg] = toks_by_slot
        hidden[pkg] = np.asarray(carry['slots']['gen_hidden'])
        compiles[pkg] = exe.compile_count - before
    assert got['torch'] == got['jax']
    np.testing.assert_allclose(hidden['torch'], hidden['jax'], **STATE_TOL)
    assert compiles['torch'] == compiles['jax'] <= 2
    # the per-slot reference loop of the port's own step program
    m, exe, scope = nmt_pair['torch']
    for slot in range(s):
        h, t, ref = h0[slot:slot + 1], np.array([[0]], np.int64), []
        for _ in range(int(budgets[slot])):
            lg, hn = exe.run(m['step'], feed={'gen_token': t,
                                              'gen_hidden': h},
                             fetch_list=[m['logits'], m['state'][0][1]],
                             scope=scope)
            nxt = int(np.argmax(lg.reshape(1, -1), axis=-1)[0])
            ref.append(nxt)
            if nxt == m['end_id']:
                break
            h, t = hn, np.array([[nxt]], np.int64)
        assert got['torch'][slot] == ref, slot


@pytest.mark.parametrize('steps', [1, 2, 5])
def test_run_decode_multi_compile_counts_match_jax(nmt_pair, steps):
    """Each new (steps, carry signature) pair counts one compile and a
    repeat none, in both packages."""
    counts = {}
    for pkg in PKGS:
        m, _, scope = nmt_pair[pkg]
        exe = FLUID[pkg].Executor(FLUID[pkg].CPUPlace())
        decode = {'token': 'gen_token', 'logits': m['logits'],
                  'state': m['state'], 'end_id': m['end_id']}
        seen = []
        for s in (2, 2, 3):
            carry = {'slots': {'gen_hidden': np.zeros((s, DIM), 'float32')},
                     'token': np.zeros((s, 1), np.int64),
                     'alive': np.ones((s, ), bool),
                     'remaining': np.full((s, ), 4, np.int32)}
            for k in (steps, steps, steps + 1):
                exe.run_decode_multi(m['step'], carry=carry, steps=k,
                                     decode=decode, scope=scope)
                seen.append(exe.compile_count)
        counts[pkg] = seen
    assert counts['torch'] == counts['jax']


class _Owner(object):
    """A holder of a decode carry, as an engine's slot cache is."""


@pytest.mark.parametrize('owners', ['none', 'one_each'])
def test_run_decode_multi_alternating_carries_like_jax(nmt_pair, owners):
    """Two slot batches decoded on one step block, their dispatches
    alternating, with no owner (each carry handed back is a copy) or one
    owner each (each replays a step of its own): every slot's tokens and
    the final hidden states equal the JAX package's decode of each batch
    alone."""
    rng = np.random.RandomState(3)
    s = 3
    budgets = np.array([4, 7, 5], np.int32)
    h0 = [rng.standard_normal((s, DIM)).astype('float32') for _ in range(2)]
    got = {}
    for pkg in PKGS:
        m, exe, scope = nmt_pair[pkg]
        decode = {'token': 'gen_token', 'logits': m['logits'],
                  'state': m['state'], 'end_id': m['end_id']}
        carries = [{'slots': {'gen_hidden': h.copy()},
                    'token': np.full((s, 1), m['start_id'], np.int64),
                    'alive': np.ones((s, ), bool),
                    'remaining': budgets.copy()} for h in h0]
        order = [0, 1] * 3 if pkg == 'torch' else [0] * 3 + [1] * 3
        owner = [_Owner() for _ in carries]
        toks = [[] for _ in carries]
        for i in order:
            kw = {}
            if pkg == 'torch' and owners == 'one_each':
                kw['owner'] = owner[i]
            carries[i], t, a = exe.run_decode_multi(
                m['step'], carry=carries[i], steps=2, decode=decode,
                scope=scope, **kw)
            t, a = np.asarray(t), np.asarray(a)
            toks[i].append(np.where(a, t, -1))
        got[pkg] = ([np.concatenate(t).tolist() for t in toks],
                    [np.asarray(c['slots']['gen_hidden']) for c in carries])
    assert got['torch'][0] == got['jax'][0]
    for ht, hj in zip(got['torch'][1], got['jax'][1]):
        np.testing.assert_allclose(ht, hj, **STATE_TOL)


def test_dead_owner_loops_are_dropped(nmt_pair):
    """A decode loop keyed by an owner leaves the block at the first
    dispatch after its owner died; another owner's loop stays."""
    m, exe, scope = nmt_pair['torch']
    carry = {'slots': {'gen_hidden': np.zeros((2, DIM), 'float32')},
             'token': np.zeros((2, 1), np.int64),
             'alive': np.ones((2, ), bool),
             'remaining': np.full((2, ), 2, np.int32)}
    _, _, _, compiled = exe._dispatch_decode_multi(
        m['step'], carry=carry, steps=1, scope=scope,
        decode={'token': 'gen_token', 'logits': m['logits'],
                'state': m['state'], 'end_id': m['end_id']})
    a, b = _Owner(), _Owner()
    ka, kb = compiled._owner_key(a), compiled._owner_key(b)
    compiled._loops[('decode', ka)] = 'loop of a'
    compiled._loops[('decode', kb)] = 'loop of b'
    del a
    assert compiled._owner_key(None) is None
    assert ('decode', ka) not in compiled._loops
    assert compiled._loops[('decode', kb)] == 'loop of b'
    del compiled._loops[('decode', kb)]


def test_upload_on_the_cpu():
    """``upload`` gives a host value on the place's device in the asked
    dtype; on the CPU it pins nothing."""
    from paddle_tpu_torch.fluid.executor import upload
    cpu = torch.device('cpu')
    t = upload(np.arange(6, dtype=np.int32).reshape(2, 3), cpu, torch.int64)
    assert t.dtype == torch.int64 and t.device == cpu and not t.is_pinned()
    assert t.tolist() == [[0, 1, 2], [3, 4, 5]]
    x = torch.ones(3)
    assert upload(x, cpu) is x


@pytest.mark.parametrize('bad', ['missing_slots', 'bad_spec', 'extra_slot',
                                 'zero_steps', 'no_state'])
def test_run_decode_multi_validates_carry_and_spec(nmt_pair, bad):
    raised = {}
    for pkg in PKGS:
        m, exe, scope = nmt_pair[pkg]
        decode = {'token': 'gen_token', 'logits': m['logits'],
                  'state': m['state'], 'end_id': m['end_id']}
        carry = {'slots': {'gen_hidden': np.zeros((2, DIM), 'float32')},
                 'token': np.zeros((2, 1), np.int64),
                 'alive': np.zeros((2, ), bool),
                 'remaining': np.zeros((2, ), np.int32)}
        kw = dict(carry=carry, steps=2, decode=decode, scope=scope)
        if bad == 'missing_slots':
            kw['carry'] = {'slots': {}}
        elif bad == 'bad_spec':
            kw['decode'] = {'token': 'gen_token'}
        elif bad == 'extra_slot':
            kw['carry'] = dict(carry, slots={
                'nope': np.zeros((2, 2), 'float32')})
        elif bad == 'zero_steps':
            kw['steps'] = 0
        else:
            kw['decode'] = dict(decode, state=[])
        with pytest.raises(ValueError) as ei:
            exe.run_decode_multi(m['step'], **kw)
        raised[pkg] = str(ei.value).split(':')[0]
    assert raised['torch'] == raised['jax']


# ---- the engine's generation lane ----------------------------------------

def test_engine_generation_token_identical_and_amortized(nmt_pair):
    """Eight mixed-length generation requests through a started engine:
    tokens equal to per-request reference decode and to the JAX engine's,
    at most a third of the reference's dispatches, the executable count
    bounded by the prefill rungs and the decode loop, and the trace's
    prefill/decode/detokenize stages summing to the measured e2e."""
    rng = np.random.RandomState(2)
    lens = [3, 6, 9, 4, 8, 5, 7, 2]
    ids = [nmt_ids(rng, n) for n in lens]
    max_lens = [8 + (i % 3) for i in range(len(ids))]
    refs, ref_disp = [], 0
    for i, n in zip(ids, max_lens):
        toks, disp = reference_decode('torch', nmt_pair, nmt_feed('torch', i),
                                      n)
        refs.append(toks)
        ref_disp += disp
    outs = {}
    for pkg in PKGS:
        fluid = FLUID[pkg]
        eng = engine(pkg, nmt_pair, 'gen-parity-' + pkg,
                     executor=fluid.Executor(fluid.CPUPlace()),
                     max_batch_size=8, max_wait_ms=2, decode_slots=4,
                     decode_steps=4)
        with eng:
            futs = [eng.submit_generate(nmt_feed(pkg, i), max_len=n)
                    for i, n in zip(ids, max_lens)]
            outs[pkg] = [[int(t) for t in f.result(120)] for f in futs]
        if pkg == 'torch':
            mm = eng.metrics()
            bd = futs[0].breakdown()
    assert outs['torch'] == outs['jax'] == refs
    d = mm['decode']
    assert (mm['dispatches'] + d['dispatches']) * 3 <= ref_disp
    assert d['requests'] == d['finished'] == len(ids)
    assert d['tokens'] == sum(len(r) for r in refs)
    assert d['tokens_per_dispatch'] > 1
    assert 0.0 < d['slot_occupancy'] <= 1.0
    assert mm['executor_compile_count'] <= 2 * len(set(lens)) + 1
    assert bd['decode_steps'] == len(outs['torch'][0])
    for stage in ('queue', 'prefill', 'decode', 'detokenize'):
        assert stage in bd['stages_ms'], bd
    assert 'device' not in bd['stages_ms']
    gap = bd['e2e_ms'] - sum(bd['stages_ms'].values())
    assert abs(gap) < max(5.0, 0.1 * bd['e2e_ms']), bd


@pytest.mark.parametrize('depth', [1, 2])
def test_engine_generation_counts_match_jax(nmt_pair, depth):
    """A deterministic inline stream (one drain coalesces the prompts):
    tokens, the engine's counts and every decode count equal to the JAX
    engine's, executables included."""
    rng = np.random.RandomState(20 + depth)
    lens = [3, 6, 9, 4, 8, 5]
    ids = [nmt_ids(rng, n) for n in lens]
    max_lens = [6 + (i % 4) for i in range(len(ids))]
    res = {}
    for pkg in PKGS:
        fluid = FLUID[pkg]
        eng = engine(pkg, nmt_pair, 'gen-counts-%s-%d' % (pkg, depth),
                     executor=fluid.Executor(fluid.CPUPlace()),
                     max_batch_size=8, decode_slots=4, decode_steps=3,
                     decode_pipeline_depth=depth)
        res[pkg] = deferred_generate(eng, [nmt_feed(pkg, i) for i in ids],
                                     max_lens)
        eng.stop()
    assert res['torch'][0] == res['jax'][0]
    assert_counts_equal(res['jax'][1], res['torch'][1])


def test_engine_generation_late_join_continuous(nmt_pair):
    """Requests submitted while the slot batch decodes join at a step
    boundary and still decode exactly as the JAX engine's."""
    rng = np.random.RandomState(4)
    ids_a = [nmt_ids(rng, n) for n in (6, 9)]
    ids_b = [nmt_ids(rng, n) for n in (3, 7, 5)]
    refs = [reference_decode('jax', nmt_pair, nmt_feed('jax', i), 10)[0]
            for i in ids_a + ids_b]
    eng = engine('torch', nmt_pair, 'gen-latejoin', max_batch_size=4,
                 max_wait_ms=1, decode_slots=2, decode_steps=2)
    with eng:
        futs = [eng.submit_generate(nmt_feed('torch', i), max_len=10)
                for i in ids_a]
        deadline = time.time() + 10
        while time.time() < deadline:
            d = eng.metrics()['decode']
            if d is not None and d['dispatches'] > 0:
                break
            time.sleep(0.005)
        futs += [eng.submit_generate(nmt_feed('torch', i), max_len=10)
                 for i in ids_b]
        outs = [[int(t) for t in f.result(120)] for f in futs]
    assert outs == refs


def test_mixed_traffic_hammer(nmt_pair):
    """Concurrent forward and generation requests against one engine:
    decode tokens equal to the JAX package's reference decode, forward
    outputs against the port's plain exe.run (the same rows, a lot of
    their own: BATCH_TOL of test_torch_serving, 2e-6 relative, as a
    coalesced row differs in the last bits) and against the JAX package's
    (STATE_TOL), forward counts unperturbed by the decode lane."""
    rng = np.random.RandomState(5)
    ids = [nmt_ids(rng, n) for n in (3, 6, 9, 4)]
    refs = [reference_decode('jax', nmt_pair, nmt_feed('jax', i), 8)[0]
            for i in ids]
    fwd_ids = [nmt_ids(rng, n) for n in (4, 7, 5, 8)]
    fwd_refs = {}
    for pkg in PKGS:
        m, exe, scope = nmt_pair[pkg]
        fwd_refs[pkg] = [np.asarray(exe.run(
            m['prefill'], feed=nmt_feed(pkg, i),
            fetch_list=m['prefill_fetches'], scope=scope)[0])
            for i in fwd_ids]
    eng = engine('torch', nmt_pair, 'gen-hammer', max_batch_size=4,
                 max_wait_ms=2, decode_slots=2, decode_steps=3)
    results = {}

    def gen_client():
        futs = [eng.submit_generate(nmt_feed('torch', i), max_len=8)
                for i in ids]
        results['gen'] = [[int(t) for t in f.result(120)] for f in futs]

    def fwd_client():
        futs = [eng.submit(nmt_feed('torch', i)) for i in fwd_ids]
        results['fwd'] = [f.result(120)[0] for f in futs]

    with eng:
        threads = [threading.Thread(target=gen_client),
                   threading.Thread(target=fwd_client)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert results['gen'] == refs
    for got, own, want in zip(results['fwd'], fwd_refs['torch'],
                              fwd_refs['jax']):
        np.testing.assert_allclose(np.asarray(got), own, rtol=2e-6, atol=0)
        np.testing.assert_allclose(np.asarray(got), want, **STATE_TOL)
    mm = eng.metrics()
    assert mm['requests'] == len(fwd_ids)
    assert mm['errors'] == 0
    assert mm['decode']['finished'] == len(ids)


def test_chained_lane_token_identical_and_fewer_syncs(nmt_pair):
    """The chained lane (depth 2) token-identical to the per-dispatch-sync
    lane (depth 1) and to the JAX engine's, with fewer host syncs at the
    same dispatch count, and non-blocking harvests."""
    rng = np.random.RandomState(12)
    ids = [nmt_ids(rng, n) for n in (3, 6, 9, 4, 8, 5)]
    refs = [reference_decode('jax', nmt_pair, nmt_feed('jax', i), 8)[0]
            for i in ids]
    outs, mets = {}, {}
    for depth in (1, 2):
        eng = engine('torch', nmt_pair, 'gen-chain-d%d' % depth,
                     max_batch_size=8, max_wait_ms=2, decode_slots=4,
                     decode_steps=3, decode_pipeline_depth=depth)
        with eng:
            futs = [eng.submit_generate(nmt_feed('torch', i), max_len=8)
                    for i in ids]
            outs[depth] = [[int(t) for t in f.result(120)] for f in futs]
        mets[depth] = eng.metrics()['decode']
    assert outs[2] == outs[1] == refs
    d1, d2 = mets[1], mets[2]
    assert d1['host_syncs'] == d1['dispatches']
    assert d2['host_syncs'] < d1['host_syncs']
    assert d2['dispatches'] <= d1['dispatches'] + 1
    assert d2['tokens'] == d1['tokens']
    assert d2['host_syncs_per_token'] < d1['host_syncs_per_token']
    assert d2['harvests'] > d2['host_syncs']


def test_stop_races_inflight_decode_chain(nmt_pair):
    """stop() racing an in-flight chain: the chain drains, every future
    resolves to the JAX package's tokens, a later submit is refused
    typed."""
    rng = np.random.RandomState(13)
    ids = [nmt_ids(rng, n) for n in (4, 7, 5, 8, 3, 6)]
    refs = [reference_decode('jax', nmt_pair, nmt_feed('jax', i), 10)[0]
            for i in ids]
    for trial in range(3):
        eng = engine('torch', nmt_pair, 'gen-stoprace-%d' % trial,
                     max_batch_size=8, max_wait_ms=1, decode_slots=2,
                     decode_steps=1, decode_pipeline_depth=3).start()
        futs = [eng.submit_generate(nmt_feed('torch', i), max_len=10)
                for i in ids]
        deadline = time.time() + 10
        while time.time() < deadline:
            d = eng.metrics()['decode']
            if d is not None and d['dispatches'] > trial:
                break
            time.sleep(0.002)
        eng.stop()
        assert not eng._decode_inflight
        for f, want in zip(futs, refs):
            assert [int(t) for t in f.result(60)] == want
        with pytest.raises(tserving.EngineClosedError):
            eng.submit_generate(nmt_feed('torch', ids[0]))


# ---- the KV-cache (Transformer) state ------------------------------------

@pytest.mark.parametrize('mode', ['started', 'inline'])
def test_kv_cache_decode_token_identical(tf_pair, mode):
    """A per-slot KV cache ([S, max_ctx, d_k] slabs and a position
    counter) through the lane: narrow prefill prefixes zero-pad into the
    slab, the step's one_hot write and masked attention extend it; tokens
    equal to the JAX package's reference decode, and (inline) every count
    equal to the JAX engine's."""
    rng = np.random.RandomState(7)
    ids = [tf_ids(rng, n) for n in (3, 5, 4, 6)]
    refs = [reference_decode('jax', tf_pair, tf_feed('jax', i),
                             TF['max_len'])[0] for i in ids]
    spec = tserving.GenerationSpec.from_model(tf_pair['torch'][0])
    assert spec.slot_shapes['gen_k'] == (TF['max_ctx'], 8)
    cfg = dict(max_batch_size=4, max_wait_ms=2, decode_slots=2,
               decode_steps=3, trailing_ladders={'gen_src': [4, 8]})
    if mode == 'started':
        eng = engine('torch', tf_pair, 'kv-gen', **cfg)
        with eng:
            futs = [eng.submit_generate(tf_feed('torch', i)) for i in ids]
            outs = [[int(t) for t in f.result(180)] for f in futs]
        assert outs == refs
        return
    res = {}
    for pkg in PKGS:
        fluid = FLUID[pkg]
        eng = engine(pkg, tf_pair, 'kv-gen-' + pkg,
                     executor=fluid.Executor(fluid.CPUPlace()), **cfg)
        res[pkg] = deferred_generate(eng, [tf_feed(pkg, i) for i in ids],
                                     [TF['max_len']] * len(ids))
        eng.stop()
    assert res['torch'][0] == res['jax'][0] == refs
    assert_counts_equal(res['jax'][1], res['torch'][1])


def test_kv_cache_admission_slabs_match_jax(tf_pair):
    """The slot slabs after admission and after decode dispatches, against
    the JAX cache's: K/V within STATE_TOL, positions and tokens exact."""
    rng = np.random.RandomState(17)
    ids = [tf_ids(rng, n) for n in (3, 6)]
    slabs = {}
    for pkg in PKGS:
        m, exe, scope = tf_pair[pkg]
        serving = SERVING[pkg]
        spec = serving.GenerationSpec.from_model(m)
        cache = serving.decode.SlotStateCache(spec, 3)
        for i in ids:
            req = serving.decode.GenerationRequest(None, 1, ('gen', ),
                                                   max_len=4)
            vals = exe.run(m['prefill'], feed=tf_feed(pkg, i),
                           fetch_list=m['prefill_fetches'], scope=scope)
            cache.admit(req, [np.asarray(v) for v in vals])
        carry, toks, alive = exe.run_decode_multi(
            m['step'], carry=cache.carry(), steps=3,
            decode=spec.decode_arg(), scope=scope)
        cache.set_carry(carry)
        c = cache.carry()
        slabs[pkg] = ({n: np.asarray(v) for n, v in c['slots'].items()},
                      np.asarray(c['token']), np.asarray(c['alive']),
                      np.asarray(c['remaining']), np.asarray(toks))
    (js, jt, ja, jr, jtk), (ts, tt, ta, tr, ttk) = slabs['jax'], \
        slabs['torch']
    for name in ('gen_k', 'gen_v'):
        np.testing.assert_allclose(ts[name], js[name], **STATE_TOL)
    np.testing.assert_array_equal(ts['gen_pos'], js['gen_pos'])
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(ttk, jtk)


# ---- registry / arbiter ----------------------------------------------------

def test_registry_decode_cache_account_warm_evict(nmt_pair):
    """The decode cache is an arbiter account: admitted at load with its
    exact bytes, warmable (decode_prefill rungs: no compile at a warm
    rung, the JAX registry's count), evictable on its own (slabs to host
    arrays, generation resuming with the same tokens), dropped at
    unload."""
    rng = np.random.RandomState(8)
    ids = nmt_ids(rng, 4)
    want = reference_decode('jax', nmt_pair, nmt_feed('jax', ids), 6)[0]
    counts = {}
    for pkg in PKGS:
        m, _, scope = nmt_pair[pkg]
        serving, fluid = SERVING[pkg], FLUID[pkg]
        spec = serving.GenerationSpec.from_model(m)
        reg = serving.ModelRegistry(place=fluid.CPUPlace())
        eng = reg.load('nmt', program=m['prefill'],
                       feed_names=m['prefill_feeds'],
                       fetch_list=m['prefill_fetches'], scope=scope,
                       executor=fluid.Executor(fluid.CPUPlace()),
                       generation=spec,
                       config=serving.ServingConfig(decode_slots=2,
                                                    decode_steps=3))
        try:
            acct = reg.arbiter.snapshot()['accounts']['nmt:decode-cache']
            assert acct['resident'] and acct['bytes'] == \
                spec.cache_nbytes(eng._decode_cache.slots)
            assert reg.warm('nmt', decode_prefill=[4]) == 1
            cc0 = eng.metrics()['executor_compile_count']
            out = reg.generate('nmt', nmt_feed(pkg, ids), max_len=6)
            assert [int(t) for t in out] == want
            counts[pkg] = (cc0, eng.metrics()['executor_compile_count'])
            moved = reg._evict_to_host('nmt:decode-cache')
            assert moved > 0
            assert isinstance(eng._decode_cache._slabs['gen_hidden'],
                              np.ndarray)
            out2 = reg.generate('nmt', nmt_feed(pkg, ids), max_len=6)
            assert [int(t) for t in out2] == want
            reg.unload('nmt')
            assert 'nmt:decode-cache' not in \
                reg.arbiter.snapshot()['accounts']
        finally:
            reg.stop()
    assert counts['torch'] == counts['jax']
    assert counts['torch'][0] == counts['torch'][1]


def test_registry_cache_alone_over_budget_is_typed_reject(nmt_pair):
    """A decode cache that can never fit is an HBMBudgetError at load,
    naming the cache's account, with nothing left loaded, as in the JAX
    registry."""
    errors = {}
    for pkg, seed in (('jax', jseed), ('torch', tseed)):
        m, exe, scope = nmt_pair[pkg]
        serving = SERVING[pkg]
        big = serving.GenerationSpec.from_model(m)
        big.slot_shapes['gen_hidden'] = (1 << 16, )
        model_seed = seed(m['prefill'], 32)
        cache_bytes = big.cache_nbytes(64)
        assert cache_bytes > 4 * model_seed
        reg = serving.ModelRegistry(
            hbm_budget_bytes=model_seed + cache_bytes // 2,
            place=FLUID[pkg].CPUPlace())
        try:
            with pytest.raises(serving.HBMBudgetError) as ei:
                reg.load('big', program=m['prefill'],
                         feed_names=m['prefill_feeds'],
                         fetch_list=m['prefill_fetches'], scope=scope,
                         executor=exe, generation=big,
                         config=serving.ServingConfig(decode_slots=64))
            errors[pkg] = (ei.value.model, ei.value.need_bytes)
            assert reg.models() == []
            assert reg.arbiter.snapshot()['accounts'] == {}
        finally:
            reg.stop()
    assert errors['torch'] == errors['jax'] == ('big:decode-cache',
                                                 cache_bytes)


# ---- observability ---------------------------------------------------------

def test_decode_error_dumps_slot_map(nmt_pair, monkeypatch):
    """A failing decode dispatch errors the slotted requests (the engine
    survives) and the flight dump carries the slot map."""
    m, _, scope = nmt_pair['torch']
    exe = tfluid.Executor(tfluid.CPUPlace())
    eng = engine('torch', nmt_pair, 'gen-err', executor=exe,
                 decode_slots=2, decode_steps=2)
    monkeypatch.setattr(
        exe, '_dispatch_decode_multi',
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError('boom')))
    rng = np.random.RandomState(9)
    fut = eng.submit_generate(nmt_feed('torch', nmt_ids(rng, 4)),
                              max_len=4)
    with pytest.raises(RuntimeError, match='boom'):
        fut.result(60)
    dump = ttrace.flight_recorder.last_dump
    assert dump['reason'] == 'decode_error:gen-err'
    sm = dump['extra']['slot_map']
    assert sm['active'] == 1
    assert fut.trace_id in sm['slot_trace_ids']
    monkeypatch.undo()
    ids = nmt_ids(rng, 3)
    want = reference_decode('jax', nmt_pair, nmt_feed('jax', ids), 4)[0]
    out = eng.generate(nmt_feed('torch', ids), max_len=4, timeout=60)
    assert [int(t) for t in out] == want
    eng.stop()


def test_stall_context_carries_decode_slot_map(nmt_pair):
    ctxs = {}
    for pkg in PKGS:
        eng = engine(pkg, nmt_pair, 'gen-stall-' + pkg, decode_slots=2)
        ctx = eng._stall_context()
        ctxs[pkg] = (ctx['decode_slot_map']['slots'],
                     ctx['decode_slot_map']['free'],
                     ctx['decode_slot_map']['bytes'],
                     ctx['decode_pending'], ctx['decode_chain'])
        eng.stop()
    assert ctxs['torch'] == ctxs['jax'] == (2, 2, ctxs['jax'][2], 0, [])


# ---- units -----------------------------------------------------------------

def test_microbatcher_separates_kinds():
    """Same-signature requests of different kinds never share a lot."""
    from paddle_tpu_torch.serving.batcher import InferenceRequest, \
        MicroBatcher
    from paddle_tpu_torch.serving.decode import GenerationRequest
    b = MicroBatcher(max_batch_size=8, max_wait_s=60)
    sig = (('x', (2, ), 'float32'), )
    fwd = InferenceRequest({'x': np.zeros((1, 2))}, 1, sig)
    gen = GenerationRequest({'x': np.zeros((1, 2))}, 1, sig, max_len=4)
    fwd2 = InferenceRequest({'x': np.zeros((1, 2))}, 1, sig)
    for r in (fwd, gen, fwd2):
        b.submit(r)
    assert b.next_lot(timeout=0, force=True) == [fwd, fwd2]
    assert b.next_lot(timeout=0, force=True) == [gen]


SPEC_ERRORS = ['align', 'state pair', 'max_len']


@pytest.mark.parametrize('err', SPEC_ERRORS)
def test_generation_spec_rejects_like_jax(nmt_pair, err):
    for pkg in PKGS:
        m = nmt_pair[pkg][0]
        serving = SERVING[pkg]
        args = [m['prefill'], m['step'], m['prefill_feeds'],
                m['prefill_fetches'], 'gen_token', m['logits'], m['state']]
        kw = {}
        if err == 'align':
            args[3] = []
        elif err == 'state pair':
            args[3], args[6] = [], []
        else:
            kw['max_len'] = 0
        with pytest.raises(ValueError, match=err):
            serving.GenerationSpec(*args, **kw)


def test_generation_spec_matches_jax(nmt_pair, tf_pair):
    for pair in (nmt_pair, tf_pair):
        specs = {pkg: SERVING[pkg].GenerationSpec.from_model(pair[pkg][0])
                 for pkg in PKGS}
        js, ts = specs['jax'], specs['torch']
        assert ts.slot_feeds == js.slot_feeds
        assert ts.slot_shapes == js.slot_shapes
        assert {n: np.dtype(d) for n, d in ts.slot_dtypes.items()} == \
            {n: np.dtype(d) for n, d in js.slot_dtypes.items()}
        for slots in (1, 4, 7):
            assert ts.cache_nbytes(slots) == js.cache_nbytes(slots)
        assert (ts.prompt_feed, ts.prompt_len_feed, ts.max_ctx) == \
            (js.prompt_feed, js.prompt_len_feed, js.max_ctx)


@pytest.mark.parametrize('case', ['feed_names', 'max_len', 'rows',
                                  'no_generation', 'trailing_off',
                                  'saved_dir'])
def test_submit_generate_rejects_like_jax(nmt_pair, case):
    rng = np.random.RandomState(11)
    for pkg in PKGS:
        m, exe, scope = nmt_pair[pkg]
        serving, fluid = SERVING[pkg], FLUID[pkg]
        spec = serving.GenerationSpec.from_model(m)
        cfg = {'trailing_buckets': False} if case == 'trailing_off' else {}
        if case == 'saved_dir':
            reg = serving.ModelRegistry(place=fluid.CPUPlace())
            with pytest.raises(ValueError, match='requires program='):
                reg.load('saved', dirname='/nonexistent', generation=spec)
            assert reg.models() == []
            reg.stop()
            continue
        eng = serving.InferenceEngine(
            m['prefill'], fetch_list=m['prefill_fetches'], scope=scope,
            executor=exe, place=fluid.CPUPlace(),
            config=serving.ServingConfig(**cfg),
            generation=None if case == 'no_generation' else spec,
            name='gen-val-%s-%s' % (case, pkg))
        prompt = nmt_feed(pkg, nmt_ids(rng, 3))
        if case == 'feed_names':
            with pytest.raises(ValueError, match='do not match'):
                eng.submit_generate({'bogus': np.zeros((1, 2))})
        elif case == 'max_len':
            with pytest.raises(ValueError, match='max_len'):
                eng.submit_generate(prompt, max_len=0)
        elif case == 'rows':
            with pytest.raises(ValueError, match='ONE sequence'):
                eng.submit_generate({'src_word_id': fluid.create_lod_tensor(
                    [[[2]], [[3]]], [[1, 1]], fluid.CPUPlace())})
        elif case == 'no_generation':
            with pytest.raises(RuntimeError, match='generation'):
                eng.submit_generate(prompt)
        else:
            with pytest.raises(ValueError, match='trailing bucketing'):
                eng.submit_generate(prompt)
        eng.stop()


# ---- the entry points default to the card ---------------------------------

@pytest.mark.parametrize('entry', ['engine', 'registry'])
def test_generation_entry_points_default_to_the_card(nmt_pair, monkeypatch,
                                                     entry):
    """No place: CUDAPlace(0), which needs a card (here none); nothing
    falls back to the CPU."""
    m, _, scope = nmt_pair['torch']
    spec = tserving.GenerationSpec.from_model(m)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        if entry == 'engine':
            tserving.InferenceEngine(
                m['prefill'], fetch_list=m['prefill_fetches'], scope=scope,
                generation=spec)
        else:
            reg = tserving.ModelRegistry()
            try:
                reg.load('nmt', program=m['prefill'],
                         feed_names=m['prefill_feeds'],
                         fetch_list=m['prefill_fetches'], scope=scope,
                         generation=spec)
            finally:
                reg.stop()


# ---- what this slice does not port ----------------------------------------

@pytest.mark.parametrize('cut', ['parallel', 'mesh', 'embed_caches',
                                 'FleetRouter', 'ReplicaServer',
                                 'OpenLoopLoadGen', 'TrafficClass'])
def test_cut_generation_features_raise_not_implemented(nmt_pair, cut):
    """dp/mesh generation, the fleet and the load generator (item 8) and
    the embedding caches (item 9) raise NotImplementedError naming their
    ROADMAP item."""
    m, exe, scope = nmt_pair['torch']
    item = {'embed_caches': 9}.get(cut, 8)
    with pytest.raises(NotImplementedError, match='item %d' % item):
        if cut in ('parallel', 'mesh', 'embed_caches'):
            value = {'parallel': True, 'mesh': {'dp': 2},
                     'embed_caches': [object()]}[cut]
            tserving.InferenceEngine(
                m['prefill'], fetch_list=m['prefill_fetches'], scope=scope,
                executor=exe, generation=tserving.GenerationSpec.from_model(
                    m), **{cut: value})
        else:
            getattr(tserving, cut)
