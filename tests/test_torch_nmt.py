"""The PyTorch port's seq2seq NMT slice held against the JAX package on the
CPU: sub-blocks (``Program.create_block``, ``clone``), each lowering the slice
adds in one-op programs (``gru_unit``, ``sequence_softmax``,
``sequence_expand``, ``fill_constant_batch_size_like``, ``gather``,
``reduce_sum``, ``beam_expand``, ``beam_init_scores``, ``beam_search`` with
finished beams, ``beam_search_decode``), each differentiable one with its
generic grad; ``StaticRNN`` and ``DynamicRNN`` programs (the ``recurrent``
op, forward and grad); the ``@SEQLEN`` keys of one step of the attention;
``seq2seq.build()``'s and ``build_decode()``'s programs in every block; NMT's
test program served and two Adam steps trained from the same state; and a
``build_decode`` request.  Dictionaries of 40-50 and widths of 8-16, as the
JAX package's own tests; the ``lstm`` op takes its scan path in both
packages, as built.

Tolerances: one-op outputs 1e-5, relative and absolute (the same f32
arithmetic up to summation order); gradients within 1e-5 of their own
max|g|.  The recurrent programs: 1e-5 on outputs, gradients within 1e-4 of
their own max|g| (sums over every step in another order).  The model
(``ModelParity``, ratios of 2-norms): loss and prediction 1e-5, gradients and
Adam's moments 1e-4, updated parameters' root mean square difference 1e-4
of lr (measured: prediction 9e-8, loss 1e-7, the worst gradient 3.7e-5,
the attention's state projection, whose gradient cancels over the source
steps; moments 3.5e-5; parameters 2.4e-5 of lr).  The decode compares
tie-aware (``chip_smoke.compare_beams``), as its weights are not drawn to
avoid ties: beam scores within 1e-4 absolute at every step (about 1e-6 of
the accumulated log-probs; measured 7.6e-6), and the beams' token prefixes
equal at every step, except where a beam at the edge of the top K is within
that tolerance of the candidate that replaced it; random weights at width 8
make such near-ties common, and ``torch.topk`` and ``jax.lax.top_k`` may
break them differently (with these inputs all four sentences agree to the
last step).
"""

import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import seq2seq as jax_seq2seq
from paddle_tpu.ops import control_flow_ops as jax_cf_ops
from paddle_tpu.ops import registry as jregistry

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.models import seq2seq as torch_seq2seq
from paddle_tpu_torch.ops import control_flow_ops as torch_cf_ops
from paddle_tpu_torch.ops import registry as tregistry

from test_torch_cv_ops import ModelParity, build_both, program_desc

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TOL = 1e-5
RNN_GRAD_TOL = 1e-4
MODEL_TOL = dict(loss=1e-5, grad=1e-4, grad_all=1e-4, accum=1e-4,
                 stats=0.0, param=1e-4, serve=1e-5, null=0.0)
BEAM_TOL = 1e-4
TRAIN = dict(src_dict_dim=50, trg_dict_dim=50, embedding_dim=16,
             encoder_size=16, decoder_size=16)
DECODE = dict(src_dict_dim=40, trg_dict_dim=40, embedding_dim=8,
              encoder_size=8, decoder_size=8)

LENGTHS = (3, 1, 5, 2)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype('float32')


# ---- one-op programs ----

def _one_op(fluid, op_type, inputs, outputs, attrs):
    """A program holding one op.  ``inputs`` {slot: (name, array)} or
    {slot: (name, array, lengths)} for a LoD input (rows concatenated);
    ``outputs`` {slot: name}.  Returns (program, feed)."""
    prog = fluid.Program()
    blk = prog.global_block()
    feed = {}
    for spec in inputs.values():
        name, arr = spec[0], spec[1]
        if len(spec) == 3:
            blk.create_var(name=name, shape=(-1, ) + arr.shape[1:],
                           dtype=str(arr.dtype), lod_level=1)
            feed[name] = fluid.create_lod_tensor(arr, [list(spec[2])])
        else:
            blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
            feed[name] = arr
    for name in outputs.values():
        blk.create_var(name=name, dtype='float32')
    blk.append_op(type=op_type,
                  inputs={s: [spec[0]] for s, spec in inputs.items()},
                  outputs={s: [n] for s, n in outputs.items()},
                  attrs=attrs)
    return prog, feed


def _run(fluid, case, fetch, cot=None, slot=None, wrt=()):
    op_type, inputs, outputs, attrs = case
    prog, feed = _one_op(fluid, op_type, inputs, outputs, attrs)
    if wrt:
        with fluid.program_guard(prog, fluid.Program()):
            blk = prog.global_block()
            cvar = blk.create_var(name='cot', shape=cot.shape,
                                  dtype='float32')
            feed['cot'] = cot
            fluid.backward.calc_gradient(
                targets=[blk.var(outputs[slot])],
                inputs=[blk.var(n) for n in wrt], target_gradients=[cvar])
        fetch = [n + '@GRAD' for n in wrt]
    out = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch, scope=fluid.Scope())
    return [np.asarray(o) for o in out]


def _check(case, slot=None, wrt=()):
    """Every output of ``case``'s op, then (with ``slot``) the gradients of
    the inputs named in ``wrt`` under a random cotangent of that output."""
    fetch = list(case[2].values())
    want = _run(jfluid, case, fetch)
    got = outputs = _run(tfluid, case, fetch)
    for name, w, g in zip(fetch, want, got):
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=name)
    if slot is None:
        return outputs
    shape = want[fetch.index(case[2][slot])].shape
    cot = np.random.RandomState(8).standard_normal(shape).astype('float32')
    want = _run(jfluid, case, None, cot, slot, wrt)
    got = _run(tfluid, case, None, cot, slot, wrt)
    for name, w, g in zip(wrt, want, got):
        assert g.shape == w.shape and np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name + '@GRAD')
    return outputs


@pytest.mark.parametrize('acts,bias', [((2, 1), True), ((3, 1), False),
                                       ((0, 2), True)])
def test_gru_unit_matches_jax(acts, bias):
    """Forward at (candidate, gate) activations (tanh, sigmoid), (relu,
    sigmoid) without a bias, (identity, tanh); the generic grad."""
    rng = np.random.RandomState(sum(acts))
    b, d = 5, 8
    inputs = {'Input': ('x', _f32(rng, b, 3 * d)),
              'HiddenPrev': ('h', _f32(rng, b, d)),
              'Weight': ('w', (_f32(rng, d, 3 * d) / np.sqrt(d)).astype(
                  'float32'))}
    if bias:
        inputs['Bias'] = ('bias', _f32(rng, 1, 3 * d))
    case = ('gru_unit', inputs, {'Gate': 'gate', 'ResetHiddenPrev': 'rhp',
                                 'Hidden': 'hid'},
            {'activation': acts[0], 'gate_activation': acts[1]})
    _check(case, 'Hidden', [spec[0] for spec in inputs.values()])


def test_gru_unit_gate_order():
    """u, r then the candidate: h = (1 - u) h_prev + u c."""
    rng = np.random.RandomState(3)
    x, h, w = _f32(rng, 4, 12), _f32(rng, 4, 4), _f32(rng, 4, 12)
    case = ('gru_unit', {'Input': ('x', x), 'HiddenPrev': ('h', h),
                         'Weight': ('w', w)},
            {'Gate': 'gate', 'ResetHiddenPrev': 'rhp', 'Hidden': 'hid'},
            {'activation': 2, 'gate_activation': 1})
    gate, rhp, hid = _check(case)
    sig = lambda v: 1 / (1 + np.exp(-v))
    u = sig(x[:, :4] + h @ w[:, :4])
    r = sig(x[:, 4:8] + h @ w[:, 4:8])
    c = np.tanh(x[:, 8:] + (r * h) @ w[:, 8:])
    np.testing.assert_allclose(hid, (1 - u) * h + u * c, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rhp, r * h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gate, np.concatenate([u, r, c], 1),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('width', [0, 1])
def test_sequence_softmax_matches_jax(width):
    """A LoD [N] or [N, 1] input (padded to [B, T] or [B, T, 1]; a
    length-0 row among them): softmax over each row's steps, zeros past
    them, and its grad."""
    rng = np.random.RandomState(width)
    lengths = (3, 0, 5, 1)
    x = _f32(rng, sum(lengths), *((1, ) if width else ()))
    case = ('sequence_softmax', {'X': ('x', x, lengths)}, {'Out': 'out'},
            {})
    out, = _check(case, 'Out', ['x'])
    assert out.ndim == 2 + width
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(out[i, :n].sum(), 1.0 if n else 0.0,
                                   rtol=1e-6)
        assert not out[i, n:].any()


def test_sequence_expand_matches_jax():
    """Each row of X across its ref's steps, and the grad (the sum over the
    steps)."""
    rng = np.random.RandomState(5)
    case = ('sequence_expand', {'X': ('x', _f32(rng, 4, 6)),
                                'Y': ('y', _f32(rng, sum(LENGTHS), 6),
                                      LENGTHS)},
            {'Out': 'out'}, {'ref_level': -1, 'expand_from_sequence': False})
    out, = _check(case, 'Out', ['x'])
    assert out.shape[:2] == (4, tfluid.executor.bucketed_len(max(LENGTHS)))


def test_nested_branches_name_the_roadmap():
    rng = np.random.RandomState(6)
    case = ('sequence_expand', {'X': ('x', _f32(rng, 4, 6)),
                                'Y': ('y', _f32(rng, sum(LENGTHS), 6),
                                      LENGTHS)},
            {'Out': 'out'}, {'ref_level': -1, 'expand_from_sequence': True})
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        _run(tfluid, case, ['out'])
    for attrs in ({'level': 1}, {'level': 0, 'row_offsets': [0, 2, 4]}):
        case = _beam_case(np.random.RandomState(7), 2, 2, 3, finished=())
        case[3].update(attrs)
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            _run(tfluid, case, ['sel_ids'])


@pytest.mark.parametrize('idx', [(0, 0), (1, 2)])
def test_fill_constant_batch_size_like_matches_jax(idx):
    ref = np.zeros((3, 7, 2), 'float32')
    case = ('fill_constant_batch_size_like', {'Input': ('ref', ref)},
            {'Out': 'out'}, {'shape': [-1, 4, 5] if idx[1] == 0
                             else [4, 5, -1], 'value': 2.5,
                             'dtype': tfluid.core.VarDesc.VarType.FP32,
                             'input_dim_idx': idx[0],
                             'output_dim_idx': idx[1]})
    out, = _check(case)
    assert out.shape[idx[1]] == ref.shape[idx[0]] and (out == 2.5).all()


def test_gather_and_reduce_sum_match_jax():
    rng = np.random.RandomState(9)
    index = np.array([3, 0, 3, 1], 'int64')
    _check(('gather', {'X': ('x', _f32(rng, 5, 6)), 'Index': ('i', index)},
            {'Out': 'out'}, {}), 'Out', ['x'])
    for attrs in ({'dim': [1], 'keep_dim': False},
                  {'dim': [0, 2], 'keep_dim': True},
                  {'dim': [0], 'reduce_all': True, 'keep_dim': False}):
        _check(('reduce_sum', {'X': ('x', _f32(rng, 3, 4, 2))},
                {'Out': 'out'}, attrs), 'Out', ['x'])


def test_beam_expand_and_init_scores_match_jax():
    rng = np.random.RandomState(10)
    out, = _check(('beam_expand', {'X': ('x', _f32(rng, 3, 4))},
                   {'Out': 'out'}, {'beam_size': 3}), 'Out', ['x'])
    assert out.shape == (9, 4)
    scores, = _check(('beam_init_scores', {'X': ('x', _f32(rng, 3, 4))},
                      {'Out': 'out'}, {'beam_size': 4}))
    np.testing.assert_array_equal(scores[:4, 0], [0, -1e9, -1e9, -1e9])
    # the lengths are repeated with the rows: a sequence op after the
    # expansion masks each beam row by its sentence's length
    lod_x = _f32(rng, sum(LENGTHS), 1)
    for fluid in (jfluid, tfluid):
        prog = fluid.Program()
        with fluid.program_guard(prog, fluid.Program()):
            x = fluid.layers.data(name='x', shape=[1], dtype='float32',
                                  lod_level=1)
            y = fluid.layers.sequence_softmax(
                fluid.layers.beam_expand(x, 2))
        got, = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={'x': fluid.create_lod_tensor(lod_x, [list(LENGTHS)])},
            fetch_list=[y], scope=fluid.Scope())
        got = np.asarray(got)[..., 0]
        for row in range(2 * len(LENGTHS)):
            n = LENGTHS[row // 2]
            np.testing.assert_allclose(got[row, :n].sum(), 1.0, rtol=1e-6)
            assert not got[row, n:].any()


def _beam_case(rng, b, k, c, finished):
    """beam_search inputs without ties: candidate scores distinct, each
    beam's top C candidates, the rows in ``finished`` at end_id 1."""
    bk = b * k
    pre_ids = rng.randint(2, 20, size=(bk, 1)).astype('int64')
    pre_ids[list(finished), 0] = 1
    pre_scores = -rng.permutation(bk).astype('float32')[:, None] - 0.5
    ids = np.stack([rng.permutation(np.arange(2, 30))[:c]
                    for _ in range(bk)]).astype('int64')
    scores = (pre_scores - (rng.permutation(bk * c).reshape(bk, c) + 1) *
              0.37).astype('float32')
    scores = -np.sort(-scores, axis=1)
    return ('beam_search',
            {'pre_ids': ('pre_ids', pre_ids),
             'pre_scores': ('pre_scores', pre_scores),
             'ids': ('ids', ids), 'scores': ('scores', scores)},
            {'selected_ids': 'sel_ids', 'selected_scores': 'sel_scores',
             'parent_idx': 'parent'},
            {'beam_size': k, 'end_id': 1, 'level': 0})


def test_beam_search_carries_finished_beams():
    """Top K of each sentence's K x C candidates; a finished beam (pre_id ==
    end_id) offers only itself, end_id at its score unchanged; parent_idx
    is a global row (values compared: the JAX package's are int32)."""
    b, k, c = 3, 4, 4
    case = _beam_case(np.random.RandomState(11), b, k, c,
                      finished=(0, 5, 6))
    sel_ids, sel_scores, parent = _check(case)
    pre_ids, pre_scores, ids, scores = (case[1][s][1] for s in (
        'pre_ids', 'pre_scores', 'ids', 'scores'))
    for s in range(b):
        cands = []
        for r in range(s * k, (s + 1) * k):
            if pre_ids[r, 0] == 1:
                cands.append((pre_scores[r, 0], 1, r))
            else:
                cands += [(scores[r, j], ids[r, j], r) for j in range(c)]
        top = sorted(cands, key=lambda e: -e[0])[:k]
        rows = slice(s * k, (s + 1) * k)
        np.testing.assert_array_equal(sel_scores[rows, 0],
                                      [e[0] for e in top])
        np.testing.assert_array_equal(sel_ids[rows, 0], [e[1] for e in top])
        np.testing.assert_array_equal(parent[rows], [e[2] for e in top])
    assert (sel_ids[parent == 0] == 1).all()


def test_beam_search_decode_backtracks():
    """Parent pointers walked back from the last step: each sentence is its
    last beam's chain of tokens; the scores are the last step's."""
    t, b, k = 3, 2, 2
    ids = np.array([[5, 6, 7, 8], [9, 10, 11, 12], [13, 14, 15, 16]],
                   'int64')[..., None]
    parents = np.array([[0, 0, 2, 2], [1, 0, 3, 3], [0, 1, 2, 2]], 'int64')
    scores = -np.arange(t * b * k, dtype='float32').reshape(t, b * k, 1)
    case = ('beam_search_decode',
            {'Ids': ('ids', ids), 'Scores': ('scores', scores),
             'ParentIdx': ('parents', parents)},
            {'SentenceIds': 'sent', 'SentenceScores': 'sent_scores'},
            {'beam_size': k, 'end_id': 1})
    sent, sent_scores = _check(case)
    np.testing.assert_array_equal(sent, [[[6, 9, 13], [5, 10, 14]],
                                         [[8, 11, 15], [8, 11, 16]]])
    np.testing.assert_array_equal(sent_scores, scores[-1, :, 0].reshape(b, k))


# ---- sub-blocks and the recurrent op ----

def _static_rnn(fluid):
    """The JAX package's test_static_rnn_sums_sequence program: the running
    sum of a time-major [4, 3, 2] input."""
    x = fluid.layers.data(name='x', shape=[4, 3, 2], dtype='float32',
                          append_batch_size=False)
    x.stop_gradient = False
    rnn = fluid.layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        mem = rnn.memory(shape=[2], batch_ref=x_t, init_value=0.0,
                         ref_batch_dim_idx=0)
        acc = fluid.layers.elementwise_add(mem, x_t)
        rnn.update_memory(mem, acc)
        rnn.output(acc)
    return x, rnn()


def test_sub_blocks_clone_and_grad_ops():
    """create_block / rollback, lookups falling through to the parent, a
    clone whose sub_block attr points into the copy, and no grad op inside
    block 1."""
    for fluid in (jfluid, tfluid):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            x, out = _static_rnn(fluid)
            loss = fluid.layers.mean(out)
            fluid.backward.append_backward(loss)
        assert prog.num_blocks == 2 and prog.current_block_idx == 0
        sub = prog.block(1)
        assert sub.parent_idx == 0
        assert sub._find_var_recursive('x') is prog.global_block().var('x')
        rec = [op for op in prog.global_block().ops
               if op.type == 'recurrent'][0]
        assert rec.attrs['sub_block'] is sub
        assert [op.type for op in sub.ops] == ['elementwise_add']
        assert 'recurrent_grad' in [op.type for op in
                                    prog.global_block().ops]
        clone = prog.clone(for_test=True)
        crec = [op for op in clone.global_block().ops
                if op.type == 'recurrent'][0]
        assert crec.attrs['sub_block'] is clone.block(1)
        assert clone.block(1) is not sub
        assert program_desc(clone) == program_desc(prog)
    with jfluid.unique_name.guard():
        jprog = jfluid.Program()
        with jfluid.program_guard(jprog, jfluid.Program()):
            _static_rnn(jfluid)
    with tfluid.unique_name.guard():
        tprog = tfluid.Program()
        with tfluid.program_guard(tprog, tfluid.Program()):
            _static_rnn(tfluid)
    assert program_desc(tprog) == program_desc(jprog)


def test_static_rnn_sums_sequence():
    """The running sum over time, and d(sum of out * cot)/dx."""
    data = np.arange(24, dtype='float32').reshape(4, 3, 2)
    cot = np.random.RandomState(12).standard_normal((4, 3, 2)).astype(
        'float32')
    results = []
    for fluid in (jfluid, tfluid):
        prog = fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(prog, fluid.Program()):
            x, out = _static_rnn(fluid)
            cvar = prog.global_block().create_var(name='cot', shape=(4, 3, 2),
                                                  dtype='float32')
            fluid.backward.calc_gradient(targets=[out], inputs=[x],
                                         target_gradients=[cvar])
        results.append([np.asarray(v) for v in fluid.Executor(
            fluid.CPUPlace()).run(prog, feed={'x': data, 'cot': cot},
                                  fetch_list=[out, 'x@GRAD'],
                                  scope=fluid.Scope())])
    (want, want_g), (got, got_g) = results
    np.testing.assert_allclose(got, np.cumsum(data, axis=0), rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=TOL)
    np.testing.assert_allclose(got_g, np.cumsum(cot[::-1], axis=0)[::-1],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_g, want_g, rtol=TOL, atol=TOL)


def _dynamic_rnn(fluid):
    """The JAX package's test_dynamic_rnn_with_memory_trains program."""
    x = fluid.layers.data(name='x', shape=[4], dtype='float32', lod_level=1)
    rnn = fluid.layers.DynamicRNN()
    with rnn.block():
        x_t = rnn.step_input(x)
        mem = rnn.memory(shape=[8], value=0.0)
        new_mem = fluid.layers.fc(input=[x_t, mem], size=8, act='tanh')
        rnn.update_memory(mem, new_mem)
        rnn.output(new_mem)
    out = rnn()
    last = fluid.layers.sequence_last_step(out)
    loss = fluid.layers.mean(fluid.layers.reduce_sum(
        fluid.layers.square(last), dim=[1]))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return out, loss


def test_dynamic_rnn_with_memory_trains_like_jax():
    """The masked loop (rows of 2, 5 and 3 steps), two SGD steps from the
    same start: the outputs (zero past each row's length), the loss, every
    gradient and the updated parameters."""
    rows = np.random.RandomState(3).randn(10, 4).astype('float32')
    runs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            out, loss = _dynamic_rnn(fluid)
        runs.append((fluid, main, startup, out, loss))
    (_, jmain, jstart, _, _), (_, tmain, _, _, _) = runs
    assert program_desc(tmain) == program_desc(jmain)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    params = [p.name for p in tmain.all_parameters()]
    tfluid.persistables_from_numpy(
        tmain, {v.name: np.asarray(jscope.find_var(v.name).value())
                for v in tmain.list_vars() if v.persistable},
        scope=tscope, place=tfluid.CPUPlace())
    fetch = [runs[0][3].name, runs[0][4].name] + [p + '@GRAD'
                                                  for p in params]
    losses = []
    for _ in range(2):
        want = jexe.run(jmain, feed={'x': jfluid.create_lod_tensor(
            rows, [[2, 5, 3]])}, fetch_list=fetch, scope=jscope)
        got = texe.run(tmain, feed={'x': tfluid.create_lod_tensor(
            rows, [[2, 5, 3]])}, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=TOL,
                                   atol=TOL)
        for i, n in enumerate((2, 5, 3)):
            assert not got[0][i, n:].any()
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=TOL)
        for name, w, g in zip(params, want[2:], got[2:]):
            w = np.asarray(w)
            assert np.abs(w).max() > 0, name
            np.testing.assert_allclose(
                g, w, rtol=0, atol=RNN_GRAD_TOL * np.abs(w).max(),
                err_msg=name + '@GRAD')
        for name in params:
            np.testing.assert_allclose(
                tscope.find_var(name).value().numpy(),
                np.asarray(jscope.find_var(name).value()), rtol=TOL,
                atol=TOL, err_msg=name)
        losses.append(float(got[1][0]))
    assert losses[1] < losses[0]


def test_attention_step_seqlen_keys_match_jax():
    """One step of the NMT decoder's block run by each package's
    ``_run_block``: the same ``@SEQLEN`` keys (the closure's sequences
    carry theirs into sequence_expand -> elementwise_add -> tanh -> fc ->
    sequence_softmax -> elementwise_mul; the step's slice, memory and
    pooled context carry none) and the same values."""
    import jax.numpy as jnp
    with jfluid.unique_name.guard():
        jm = jax_seq2seq.build(**TRAIN)
    with tfluid.unique_name.guard():
        tm = torch_seq2seq.build(**TRAIN)
    rng = np.random.RandomState(13)
    b, t, d = 3, 16, 16
    lengths = np.array([4, 16, 9], 'int32')
    jblock, tblock = jm['main'].block(1), tm['main'].block(1)
    rec = [op for op in tm['main'].global_block().ops
           if op.type == 'recurrent'][0]
    vals = {}
    for name in rec.input('StaticInputs'):
        vals[name] = _f32(rng, b, t, d)
        vals[name + '@SEQLEN'] = lengths
    for name in rec.input('ClosureInputs'):
        var = tm['main'].global_block().var(name)
        vals[name] = _f32(rng, *var.shape) * 0.3
    vals[rec.attrs['step_input_names'][0]] = _f32(rng, b, d)
    vals[rec.attrs['mem_names'][0]] = _f32(rng, b, d)
    jenv = {k: jnp.asarray(v) for k, v in vals.items()}
    tenv = {k: torch.from_numpy(v) for k, v in vals.items()}
    jax_cf_ops._run_block(jregistry.LoweringContext(jblock, jenv), jblock,
                          jenv)
    torch_cf_ops._run_block(tregistry.LoweringContext(
        tblock, tenv, tfluid.CPUPlace()), tblock, tenv)
    jkeys = sorted(k for k in jenv if k.endswith('@SEQLEN'))
    tkeys = sorted(k for k in tenv if k.endswith('@SEQLEN'))
    assert tkeys == jkeys
    assert any(k.startswith('sequence_expand') for k in tkeys)
    assert not any(k.startswith(('sequence_pool', 'gru_unit')) for k in tkeys)
    for name in jenv:
        np.testing.assert_allclose(tenv[name].numpy(), np.asarray(jenv[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)


# ---- the model ----

def test_seq2seq_builds_the_jax_programs():
    """build()'s main, test and startup programs and build_decode()'s, every
    block; chip_smoke's NMT builder gives build()'s programs as built and
    differs only in the LSTM's bias and attrs without peepholes."""
    jm, tm = build_both(jax_seq2seq, torch_seq2seq, **TRAIN)
    assert tm['main'].num_blocks == tm['test'].num_blocks == 2
    assert 'recurrent_grad' in [op.type for op in
                                tm['main'].global_block().ops]
    assert not any(op.type.endswith('_grad')
                   for op in tm['main'].block(1).ops)
    with jfluid.unique_name.guard():
        jd = jax_seq2seq.build_decode(**DECODE)
    with tfluid.unique_name.guard():
        td = torch_seq2seq.build_decode(**DECODE)
    for key in ('main', 'startup'):
        assert program_desc(td[key]) == program_desc(jd[key]), key
    with tfluid.unique_name.guard():
        same = chip_smoke.nmt_programs(use_peepholes=True, **TRAIN)
    for key in ('main', 'test', 'startup'):
        assert program_desc(same[key]) == program_desc(tm[key]), key
    with tfluid.unique_name.guard():
        bare = chip_smoke.nmt_programs(use_peepholes=False, **TRAIN)
    assert [op.type for op in bare['main'].global_block().ops] == \
        [op.type for op in tm['main'].global_block().ops]
    lstm = [op for op in bare['main'].global_block().ops
            if op.type == 'lstm'][0]
    assert lstm.attrs['use_peepholes'] is False
    assert bare['main'].global_block().var(lstm.input('Bias')[0]).shape == \
        (1, 4 * TRAIN['encoder_size'])


def _nmt_feed(fluid, seed, pairs):
    rng = np.random.RandomState(seed)
    src_len = rng.randint(3, 9, size=pairs)
    trg_len = rng.randint(3, 9, size=pairs)
    src = rng.randint(2, TRAIN['src_dict_dim'], size=(src_len.sum(), 1))
    trg = rng.randint(2, TRAIN['trg_dict_dim'], size=(trg_len.sum(), 1))
    nxt = np.concatenate([np.append(r[1:], 1) for r in np.split(
        trg[:, 0], np.cumsum(trg_len)[:-1])])[:, None]
    lod = lambda a, n: fluid.create_lod_tensor(a.astype('int64'),
                                               [n.tolist()])
    return {'src_word_id': lod(src, src_len),
            'target_language_word': lod(trg, trg_len),
            'target_language_next_word': lod(nxt, trg_len)}


def test_nmt_serves_and_trains_like_jax():
    """The test program's prediction, then two Adam steps from the same
    state: loss, every gradient, the parameters and Adam's moments."""
    jm, tm = build_both(jax_seq2seq, torch_seq2seq, **TRAIN)
    model = ModelParity(jm, tm)
    pred, = model.serve(lambda fluid: _nmt_feed(fluid, 20, 4),
                        [tm['prediction'].name], MODEL_TOL)
    assert pred.shape[0] == 4 and pred.shape[2] == TRAIN['trg_dict_dim']
    for seed in (21, 22):
        assert np.isfinite(model.step(
            lambda fluid: _nmt_feed(fluid, seed, 4), MODEL_TOL))


def test_nmt_decode_like_jax():
    """A build_decode request of four sentences, tie-aware."""
    with jfluid.unique_name.guard():
        jd = jax_seq2seq.build_decode(**DECODE)
    with tfluid.unique_name.guard():
        td = torch_seq2seq.build_decode(**DECODE)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jd['startup'], scope=jscope)
    tscope = tfluid.Scope()
    tfluid.persistables_from_numpy(
        td['main'], {v.name: np.asarray(jscope.find_var(v.name).value())
                     for v in td['main'].list_vars() if v.persistable},
        scope=tscope, place=tfluid.CPUPlace())
    rng = np.random.RandomState(23)
    lengths = [3, 7, 5, 4]
    src = rng.randint(2, DECODE['src_dict_dim'], size=(sum(lengths), 1))
    fetch = chip_smoke.decode_fetch(td)
    want = jexe.run(jd['main'], feed={'src_word_id': jfluid.create_lod_tensor(
        src.astype('int64'), [lengths])}, fetch_list=fetch, scope=jscope)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        td['main'], feed={'src_word_id': tfluid.create_lod_tensor(
            src.astype('int64'), [lengths])}, fetch_list=fetch, scope=tscope)
    beam = 4
    assert got[3].shape == (4, beam, 16) and got[4].shape == (4, beam)
    problems, stats = chip_smoke.compare_beams(
        got, [np.asarray(w) for w in want], beam, BEAM_TOL)
    assert not problems, problems
    # the comparison reached the last step for some sentence
    assert stats['compared_to_end'] >= 1, stats
