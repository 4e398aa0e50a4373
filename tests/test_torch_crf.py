"""The PyTorch port's book-model lowerings held against the JAX package on
the CPU, one-op program against one-op program on the same seeded numpy
inputs: ``linear_chain_crf`` and ``crf_decoding`` over ragged LoD (a row of
length 1 and one of the padded T among them; ``crf_decoding`` with and
without a Label), ``cos_sim`` (Y of B rows and of 1 row),
``sequence_conv`` (contextLength 3 and 5, ragged), ``clip``,
``clip_by_norm`` (above and below its norm) and ``sign``; each
differentiable one's generic grad (``torch.func.vjp``) against the JAX
package's (``jax.vjp``).  Then the port's CRF against brute-force path
enumeration (the negative log-likelihood and the Viterbi path, as
``tests/test_crf.py`` holds the JAX package), the Label indicator, the
host op ``chunk_eval`` and the streaming ``ChunkEvaluator`` against the
JAX package's counts, and the executor's treatment of a block that holds
a host op.

Tolerance: 1e-5, relative and absolute, for every float output and
gradient (the same f32 arithmetic up to summation order; the gradients are
scaled by max(1, max|g|)); Viterbi paths, the indicator and the chunk
counts exactly; the brute-force nll within 1e-4 (as ``tests/test_crf.py``).
"""

import itertools

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import registry as tregistry

TOL = 1e-5


def _lod(fluid, flat, lengths):
    lt = fluid.core.LoDTensor(flat)
    lt.set_recursive_sequence_lengths([list(lengths)])
    return lt


def _program(fluid, op_type, inputs, outputs, attrs):
    """A program holding one op.  ``inputs`` {slot: (name, array, lengths)}
    (``lengths`` None for a dense var, else the rows of a one-level LoD
    over ``array``'s dim 0); ``outputs`` {slot: (name, dtype)}.  Returns
    (program, feed)."""
    prog = fluid.Program()
    blk = prog.global_block()
    feed = {}
    for name, arr, lengths in inputs.values():
        if lengths is None:
            blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
            feed[name] = arr
        else:
            blk.create_var(name=name, shape=(-1, ) + arr.shape[1:],
                           dtype=str(arr.dtype), lod_level=1)
            feed[name] = _lod(fluid, arr, lengths)
    for name, dtype in outputs.values():
        blk.create_var(name=name, dtype=dtype)
    blk.append_op(type=op_type,
                  inputs={s: [v[0]] for s, v in inputs.items()},
                  outputs={s: [v[0]] for s, v in outputs.items()},
                  attrs=attrs)
    return prog, feed


def _forward(fluid, case):
    op_type, inputs, outputs, attrs = case
    prog, feed = _program(fluid, op_type, inputs, outputs, attrs)
    out = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=[n for n, _ in outputs.values()],
        scope=fluid.Scope())
    return [np.asarray(o) for o in out]


def _grads(fluid, case, slot, wrt, cot):
    """The gradients of the vars ``wrt`` with the cotangent ``cot`` fed to
    the output ``slot``."""
    op_type, inputs, outputs, attrs = case
    prog, feed = _program(fluid, op_type, inputs, outputs, attrs)
    with fluid.program_guard(prog, fluid.Program()):
        blk = prog.global_block()
        cvar = blk.create_var(name='cot', shape=cot.shape, dtype='float32')
        feed['cot'] = cot
        fluid.backward.calc_gradient(targets=[blk.var(outputs[slot][0])],
                                     inputs=[blk.var(n) for n in wrt],
                                     target_gradients=[cvar])
    out = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=[n + '@GRAD' for n in wrt],
        scope=fluid.Scope())
    return [np.asarray(o) for o in out]


def _check(case, slot=None, wrt=(), nonzero=True):
    """Forward outputs (exactly where integer), then the gradients of
    ``wrt`` with ``slot``'s cotangent, of the port against the JAX
    package (``nonzero``: each gradient has a nonzero element).  Returns
    the port's forward outputs."""
    want = _forward(jfluid, case)
    got = _forward(tfluid, case)
    for (name, _), w, g in zip(case[2].values(), want, got):
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=name)
    if slot is not None:
        shape = want[list(case[2]).index(slot)].shape
        cot = np.random.RandomState(8).standard_normal(shape).astype(
            'float32')
        want_g = _grads(jfluid, case, slot, wrt, cot)
        got_g = _grads(tfluid, case, slot, wrt, cot)
        for name, w, g in zip(wrt, want_g, got_g):
            assert g.shape == w.shape, name
            assert np.abs(w).max() > 0 or not nonzero, name
            np.testing.assert_allclose(
                g, w, rtol=TOL, atol=TOL * max(1.0, np.abs(w).max()),
                err_msg=name + '@GRAD')
    return got


# ---- the CRF lowerings ----

LENGTHS = [(1, 16, 7, 3), (16, ), (5, 1, 12)]


def _crf_inputs(lengths, d, seed, label=True):
    rng = np.random.RandomState(seed)
    n = sum(lengths)
    inputs = {
        'Emission': ('em', rng.standard_normal((n, d)).astype('float32'),
                     lengths),
        'Transition': ('tr', rng.standard_normal((d + 2, d)).astype(
            'float32'), None),
    }
    if label:
        inputs['Label'] = ('lab', rng.randint(0, d, (n, 1)).astype('int64'),
                           lengths)
    return inputs


@pytest.mark.parametrize('lengths', LENGTHS)
def test_linear_chain_crf_matches_jax(lengths):
    case = ('linear_chain_crf', _crf_inputs(lengths, 5, 1),
            {'LogLikelihood': ('nll', 'float32')}, {})
    _check(case, 'LogLikelihood', wrt=('em', 'tr'))


@pytest.mark.parametrize('lengths', LENGTHS)
@pytest.mark.parametrize('label', [False, True])
def test_crf_decoding_matches_jax(lengths, label):
    case = ('crf_decoding', _crf_inputs(lengths, 5, 2, label=label),
            {'ViterbiPath': ('path', 'int64')}, {})
    path, = _check(case)
    t = max(16, max(lengths))
    assert path.shape == (len(lengths), t, 1)
    for i, n in enumerate(lengths):
        assert not path[i, n:].any()  # padding steps are 0


# ---- cos_sim, sequence_conv, clip, clip_by_norm, sign ----

@pytest.mark.parametrize('y_rows', [6, 1])
def test_cos_sim_matches_jax(y_rows):
    rng = np.random.RandomState(3)
    case = ('cos_sim',
            {'X': ('x', rng.standard_normal((6, 9)).astype('float32'), None),
             'Y': ('y', rng.standard_normal((y_rows, 9)).astype('float32'),
                   None)},
            {'Out': ('out', 'float32'), 'XNorm': ('xn', 'float32'),
             'YNorm': ('yn', 'float32')}, {})
    _check(case, 'Out', wrt=('x', 'y'))


@pytest.mark.parametrize('context', [3, 5])
def test_sequence_conv_matches_jax(context):
    rng = np.random.RandomState(4)
    lengths = (4, 1, 16, 9)
    d, m = 6, 7
    case = ('sequence_conv',
            {'X': ('x', rng.standard_normal((sum(lengths), d)).astype(
                'float32'), lengths),
             'Filter': ('w', rng.standard_normal((context * d, m)).astype(
                 'float32'), None)},
            {'Out': ('out', 'float32')},
            {'contextStride': 1, 'contextStart': -(context // 2),
             'contextLength': context})
    _check(case, 'Out', wrt=('x', 'w'))


def _dense(slot_arrays):
    return {s: (n, a, None) for s, (n, a) in slot_arrays.items()}


def test_clip_matches_jax():
    x = np.random.RandomState(5).standard_normal((7, 8)).astype('float32')
    case = ('clip', _dense({'X': ('x', x)}), {'Out': ('out', 'float32')},
            {'min': -0.5, 'max': 0.8})
    out, = _check(case, 'Out', wrt=('x', ))
    assert out.min() == np.float32(-0.5) and out.max() == np.float32(0.8)


@pytest.mark.parametrize('max_norm', [1.0, 1e3])
def test_clip_by_norm_matches_jax(max_norm):
    x = np.random.RandomState(6).standard_normal((7, 8)).astype('float32')
    case = ('clip_by_norm', _dense({'X': ('x', x)}),
            {'Out': ('out', 'float32')}, {'max_norm': max_norm})
    out, = _check(case, 'Out', wrt=('x', ))
    np.testing.assert_allclose(np.linalg.norm(out),
                               min(max_norm, np.linalg.norm(x)), rtol=1e-5)


def test_sign_matches_jax():
    x = np.random.RandomState(7).standard_normal((7, 8)).astype('float32')
    x[0, :3] = 0.0
    _check(('sign', _dense({'X': ('x', x)}), {'Out': ('out', 'float32')},
            {}), 'Out', wrt=('x', ), nonzero=False)  # 0 almost everywhere


def test_clip_and_l1_decay_run_in_a_training_step():
    """``GradientClipByValue``, ``GradientClipByNorm`` and ``L1Decay`` build
    ``clip``, ``clip_by_norm`` and ``sign``: one SGD step of each package
    from one state leaves the same parameters."""
    rng = np.random.RandomState(9)
    x = rng.standard_normal((8, 5)).astype('float32')
    y = rng.standard_normal((8, 1)).astype('float32')
    w0 = rng.standard_normal((5, 1)).astype('float32')
    got = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(main, startup):
            xv = fluid.layers.data(name='x', shape=[5], dtype='float32')
            yv = fluid.layers.data(name='y', shape=[1], dtype='float32')
            pred = fluid.layers.fc(
                input=xv, size=1, bias_attr=False,
                param_attr=fluid.ParamAttr(
                    name='w', regularizer=fluid.regularizer.L1Decay(0.1),
                    gradient_clip=fluid.clip.GradientClipByNorm(0.5)))
            pred2 = fluid.layers.fc(
                input=xv, size=1, bias_attr=False,
                param_attr=fluid.ParamAttr(
                    name='w2',
                    gradient_clip=fluid.clip.GradientClipByValue(0.05)))
            loss = fluid.layers.mean(fluid.layers.square_error_cost(
                input=fluid.layers.elementwise_add(pred, pred2), label=yv))
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        types = {op.type for op in main.global_block().ops}
        assert {'clip', 'clip_by_norm', 'sign'} <= types
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        scope.var('w').set_value(w0.copy() if fluid is jfluid else
                                 tfluid.LoDTensor(w0.copy()).tensor())
        scope.var('w2').set_value(-w0 if fluid is jfluid else
                                  tfluid.LoDTensor(-w0).tensor())
        exe.run(main, feed={'x': x, 'y': y}, fetch_list=[loss], scope=scope)
        got.append([np.asarray(scope.find_var(n).value()).copy()
                    if fluid is jfluid else
                    scope.find_var(n).value().numpy().copy()
                    for n in ('w', 'w2')])
    for w, g in zip(*got):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    assert not np.allclose(got[1][0], w0)


# ---- the CRF against brute force (the port's counterparts of
# tests/test_crf.py) ----

def _brute_force(emission, transition, label):
    """Enumerate every path of one sequence: (nll of label, best path)."""
    t, d = emission.shape
    w_start, w_end, w = transition[0], transition[1], transition[2:]

    def path_score(path):
        s = w_start[path[0]] + w_end[path[-1]] + emission[0, path[0]]
        for i in range(1, t):
            s += w[path[i - 1], path[i]] + emission[i, path[i]]
        return s

    scores = {p: path_score(p) for p in itertools.product(range(d),
                                                          repeat=t)}
    all_s = np.array(list(scores.values()))
    m = all_s.max()
    log_z = m + np.log(np.exp(all_s - m).sum())
    best = max(scores, key=scores.get)
    return log_z - path_score(tuple(label)), list(best)


def test_linear_chain_crf_matches_brute_force():
    rng = np.random.RandomState(7)
    d = 3
    lengths = [3, 4, 1]
    emissions = [rng.standard_normal((n, d)).astype('float32')
                 for n in lengths]
    labels = [rng.randint(0, d, size=n).tolist() for n in lengths]
    transition = rng.standard_normal((d + 2, d)).astype('float32')
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        em = tfluid.layers.data(name='em', shape=[d], dtype='float32',
                                lod_level=1)
        lab = tfluid.layers.data(name='lab', shape=[1], dtype='int64',
                                 lod_level=1)
        nll = tfluid.layers.linear_chain_crf(
            input=em, label=lab, param_attr=tfluid.ParamAttr(name='crfw'))
        decode = tfluid.layers.crf_decoding(
            input=em, param_attr=tfluid.ParamAttr(name='crfw'))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.persistables_from_numpy(prog, {'crfw': transition}, scope=scope,
                                   place=tfluid.CPUPlace())
    out, dec = exe.run(
        prog, feed={'em': _lod(tfluid, np.concatenate(emissions), lengths),
                    'lab': _lod(tfluid, np.concatenate(labels).reshape(
                        -1, 1).astype('int64'), lengths)},
        fetch_list=[nll, decode], scope=scope)
    for i, (e, l) in enumerate(zip(emissions, labels)):
        want_nll, want_path = _brute_force(e, transition, l)
        np.testing.assert_allclose(out[i, 0], want_nll, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(dec[i, :len(want_path), 0], want_path)
        assert np.all(dec[i, len(want_path):] == 0)  # padding


def test_crf_decoding_with_label_marks_correct_tokens():
    rng = np.random.RandomState(3)
    d = 4
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        em = tfluid.layers.data(name='em', shape=[d], dtype='float32',
                                lod_level=1)
        lab = tfluid.layers.data(name='lab', shape=[1], dtype='int64',
                                 lod_level=1)
        decode = tfluid.layers.crf_decoding(
            input=em, param_attr=tfluid.ParamAttr(name='crfw'))
        correct = tfluid.layers.crf_decoding(
            input=em, param_attr=tfluid.ParamAttr(name='crfw'), label=lab)
    emission = rng.standard_normal((5, d)).astype('float32')
    transition = rng.standard_normal((d + 2, d)).astype('float32')
    labels = rng.randint(0, d, size=5)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.persistables_from_numpy(prog, {'crfw': transition}, scope=scope,
                                   place=tfluid.CPUPlace())
    with pytest.warns(UserWarning, match='zero-initialized'):
        # a decoding-only program gets the parameter zero-initialized
        with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
            tfluid.layers.crf_decoding(
                input=tfluid.layers.data(name='em', shape=[d],
                                         dtype='float32', lod_level=1),
                param_attr=tfluid.ParamAttr(name='crfw'))
    dec, cor = exe.run(
        prog, feed={'em': _lod(tfluid, emission, [5]),
                    'lab': _lod(tfluid, labels.reshape(-1, 1).astype(
                        'int64'), [5])},
        fetch_list=[decode, correct], scope=scope)
    np.testing.assert_array_equal(
        cor[0, :5, 0], (dec[0, :5, 0] == labels).astype('int64'))


# ---- chunk_eval, ChunkEvaluator and the host-op path ----

# IOB tags of 3 chunk types: B-k = 2k, I-k = 2k + 1, O = 6
INFER = [[0, 1, 6, 2, 6, 4, 5], [6, 0], [2, 3, 3]]
LABEL = [[0, 1, 6, 2, 3, 4, 5], [6, 0], [2, 3, 6]]


def _tags(fluid, rows):
    flat = np.asarray([t for r in rows for t in r], 'int64').reshape(-1, 1)
    return _lod(fluid, flat, [len(r) for r in rows])


def _chunk_program(fluid, excluded=None):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        inf = fluid.layers.data(name='inf', shape=[1], dtype='int64',
                                lod_level=1)
        lab = fluid.layers.data(name='lab', shape=[1], dtype='int64',
                                lod_level=1)
        outs = fluid.layers.chunk_eval(input=inf, label=lab,
                                       chunk_scheme='IOB', num_chunk_types=3,
                                       excluded_chunk_types=excluded)
    return prog, outs


@pytest.mark.parametrize('excluded', [None, [1]])
def test_chunk_eval_matches_jax(excluded):
    got = []
    for fluid in (jfluid, tfluid):
        prog, outs = _chunk_program(fluid, excluded)
        got.append(fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={'inf': _tags(fluid, INFER),
                        'lab': _tags(fluid, LABEL)},
            fetch_list=list(outs), scope=fluid.Scope()))
    want, port = got
    for w, g in zip(want, port):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert port[3][0] > 0 and port[5][0] > 0


def _evaluator(fluid):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        inf = fluid.layers.data(name='inf', shape=[1], dtype='int64',
                                lod_level=1)
        lab = fluid.layers.data(name='lab', shape=[1], dtype='int64',
                                lod_level=1)
        ev = fluid.evaluator.ChunkEvaluator(
            input=inf, label=lab, chunk_scheme='IOB', num_chunk_types=3)
    return prog, startup, ev


def test_chunk_evaluator_streams_like_jax():
    """Two different batches accumulate into the evaluator's int64 state
    (``sums(..., out=state)``, run in place of the state var), and eval
    gives the JAX package's precision, recall and F1; reset zeroes it."""
    batches = [(INFER, LABEL), (LABEL[::-1], INFER[::-1])]
    got = []
    for fluid in (jfluid, tfluid):
        prog, startup, ev = _evaluator(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            counts = []
            for inf, lab in batches:
                exe.run(prog, feed={'inf': _tags(fluid, inf),
                                    'lab': _tags(fluid, lab)},
                        fetch_list=[])
                counts.append([int(np.asarray(
                    scope.find_var(s.name).value()).reshape(-1)[0])
                    for s in ev.states])
            got.append((counts, ev.eval(exe)))
            ev.reset(exe)
            assert all(int(np.asarray(scope.find_var(
                s.name).value()).reshape(-1)[0]) == 0 for s in ev.states)
    (want_counts, want), (port_counts, port) = got
    assert port_counts == want_counts and port_counts[1] != port_counts[0]
    np.testing.assert_allclose(port, want, rtol=1e-6)
    assert port.dtype == np.float32 and 0 < port[2] < 1


def test_host_op_block_runs_eagerly_and_refuses_multi():
    """A block with a host op is refused capture (the registry declares
    every host op uncapturable), runs op by op, and run_multi,
    run_eval_multi and memory_analysis raise with the JAX package's
    messages."""
    assert tregistry.is_host_op_type('chunk_eval')
    assert tregistry.get_host_op('chunk_eval') is not None
    assert not tregistry.is_host_op_type('crf_decoding')
    prog, startup, ev = _evaluator(tfluid)
    feed = {'inf': _tags(tfluid, INFER), 'lab': _tags(tfluid, LABEL)}
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(prog, feed=feed, fetch_list=ev.metrics, scope=scope)
    block, = [b for b in exe.cached_blocks() if b.program is prog]
    assert block.mode == 'eager' and block.captures == 0
    assert block.host_ops == ['chunk_eval']
    assert 'host op' in block.refusal
    for call in (lambda: exe.run_multi(prog, feed=feed, fetch_list=[],
                                       steps=2, scope=scope),
                 lambda: exe.run_eval_multi(prog, feed=feed,
                                            fetch_list=ev.metrics, steps=2,
                                            scope=scope)):
        with pytest.raises(RuntimeError, match='contains host ops and '
                           'cannot run as one on-device loop'):
            call()
    with pytest.raises(RuntimeError, match=r"memory_analysis: the program "
                       r"contains host ops \(\['chunk_eval'\]\)"):
        exe.memory_analysis(prog, feed=feed, fetch_list=[], scope=scope)
    jprog, jstartup, _ = _evaluator(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    jfeed = {'inf': _tags(jfluid, INFER), 'lab': _tags(jfluid, LABEL)}
    with pytest.raises(RuntimeError, match='contains host ops and cannot '
                       'run as one on-device loop'):
        jexe.run_multi(jprog, feed=jfeed, fetch_list=[], steps=2,
                       scope=jscope)
    # three runs accumulated three batches' counts
    assert [int(scope.find_var(s.name).value().reshape(-1)[0])
            for s in ev.states] == [3 * 5, 3 * 5, 3 * 3]


def test_host_op_walk_checks_nan_and_frees_marked_vars():
    """The eager walk applies FLAGS_check_nan_inf to a host op's outputs
    (an int64 count is no float and never trips it), and its release plan
    frees only what ``memory_optimize`` marked."""
    prog, outs = _chunk_program(tfluid)
    tfluid.memory_optimize(prog)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    tfluid.FLAGS.check_nan_inf = True
    try:
        got = exe.run(prog, feed={'inf': _tags(tfluid, INFER),
                                  'lab': _tags(tfluid, LABEL)},
                      fetch_list=[outs[2]], scope=scope)
    finally:
        tfluid.FLAGS.check_nan_inf = False
    assert np.isfinite(got[0]).all()
    block, = exe.cached_blocks()
    freed = {n for names in block._release.values() for n in names}
    assert freed and freed <= set(prog._releasable)
