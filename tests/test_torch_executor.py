"""The PyTorch port's compiled executor path against the JAX package's, on
the CPU: the compile cache (``compile_count`` over the same sequence of runs
in both packages, program versions, the weakref purge, the LRU), ``run_multi``
(the six cases of ``tests/test_run_multi.py``, against the JAX package's
``run_multi`` and against K sequential runs of the port) and
``run_eval_multi`` (equal lots, lots of other time extents, lots of other row
counts), the error cases of both, and a parameter replaced in the scope
between two runs.

The CUDA graph capture runs only on a card (``chip_smoke.py``); here every
block runs eagerly, as a CPU place does, and the tests pin what the cache and
the multi-step entry points compute.

Tolerances: losses, fetches and SGD-trained parameters within 1e-5
(absolute, values of order 1) of the JAX package.  Adam moves an element
whose gradient is rounding noise by up to lr either way, so under Adam no
parameter may differ by more than 2 lr a step, and at most 1e-3 of the
elements by more than 1e-5.  A run_multi in the port against its own K
sequential runs is bitwise on the CPU, where the two paths run the same
lowerings in the same order.
"""

import gc

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.ops import registry as tregistry

TOL = 1e-5
BOTH = (('jax', jfluid), ('torch', tfluid))


def _place(fluid):
    return fluid.CPUPlace()


def _mlp(fluid, lr=0.5, train=True):
    """tests/test_run_multi.py's model: fc(4 -> 3) softmax, SGD."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data('x', [4])
        label = fluid.layers.data('label', [1], dtype='int64')
        pred = fluid.layers.fc(x, 3, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        if train:
            fluid.optimizer.SGD(lr).minimize(loss)
    return dict(main=prog, startup=startup, loss=loss, pred=pred)


def _mnist_mlp(fluid):
    """The MNIST MLP at its published width (784-200-200-10), Adam."""
    from importlib import import_module
    mnist = import_module(fluid.__name__.split('.')[0] + '.models.mnist')
    with fluid.unique_name.guard():
        m = mnist.build(lr=0.01)
    return dict(main=m['main'], startup=m['startup'], loss=m['loss'],
                pred=m['prediction'])


def _lod_net(fluid):
    """tests/test_run_multi.py's LoD model: embedding, sum pool, fc, SGD."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        words = fluid.layers.data('words', shape=[1], dtype='int64',
                                  lod_level=1)
        emb = fluid.layers.embedding(words, size=[50, 8])
        pooled = fluid.layers.sequence_pool(emb, 'sum')
        pred = fluid.layers.fc(pooled, 2)
        loss = fluid.layers.mean(pred)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return dict(main=prog, startup=startup, loss=loss, pred=pred)


def _stacked_lstm(fluid):
    """The stacked LSTM at a tiny width: dictionary 40, hidden 8, 2 layers."""
    from importlib import import_module
    sl = import_module(fluid.__name__.split('.')[0] + '.models.stacked_lstm')
    with fluid.unique_name.guard():
        m = sl.build(dict_dim=40, emb_dim=8, hid_dim=8, stacked_num=2,
                     lr=0.01)
    return dict(main=m['main'], startup=m['startup'], loss=m['loss'],
                pred=m['prediction'], test=m['test'])


def _dense_feed(rng, rows=8, width=4):
    return {'x': rng.rand(rows, width).astype('float32'),
            'label': rng.randint(0, 3, (rows, 1)).astype('int64')}


def _mnist_feed(rng, rows=8):
    return {'img': rng.rand(rows, 784).astype('float32'),
            'label': rng.randint(0, 10, (rows, 1)).astype('int64')}


def _lod_feed(fluid, rng, rows=4, lo=3, hi=15, vocab=50, label=False):
    lens = rng.randint(lo, hi, size=rows)
    seqs = [rng.randint(0, vocab, size=(n, 1)).tolist() for n in lens]
    feed = {'words': fluid.create_lod_tensor(seqs, [[len(s) for s in seqs]],
                                             fluid.CPUPlace())}
    if label:
        feed['label'] = rng.randint(0, 2, (rows, 1)).astype('int64')
    return feed


class Pair(object):
    """One model in both packages: the JAX startup run, and the port's scope
    given the same state by ``persistables_from_numpy``."""

    def __init__(self, build):
        self.m = {name: build(fluid) for name, fluid in BOTH}
        self.jscope, self.tscope = jfluid.Scope(), tfluid.Scope()
        self.jexe = jfluid.Executor(jfluid.CPUPlace())
        self.texe = tfluid.Executor(tfluid.CPUPlace())
        self.jexe.run(self.m['jax']['startup'], scope=self.jscope)
        main = self.m['jax']['main']
        self.start = {v.name: np.asarray(self.jscope.find_var(v.name).value())
                      for v in main.list_vars() if v.persistable}
        self.handover()

    def handover(self, scope=None):
        """The state after the JAX startup into ``scope``."""
        scope = scope if scope is not None else self.tscope
        tfluid.persistables_from_numpy(self.m['torch']['main'], self.start,
                                       scope=scope, place=tfluid.CPUPlace())

    def feed(self, fluid_name, feed):
        """A feed for ``fluid_name``'s package: LoD tensors rebuilt there."""
        fluid = dict(BOTH)[fluid_name]
        out = {}
        for k, v in feed.items():
            if hasattr(v, 'lod') and v.lod():
                out[k] = fluid.create_lod_tensor(
                    np.asarray(v), v.recursive_sequence_lengths(),
                    fluid.CPUPlace())
            else:
                out[k] = v
        return out


# ----------------------------------------------------------------------------
# the compile cache
# ----------------------------------------------------------------------------
def _count_sequence(fluid):
    """compile_count after each run of one fixed sequence."""
    m = _mlp(fluid, train=False)
    exe = fluid.Executor(_place(fluid))
    scope = fluid.Scope()
    rng = np.random.RandomState(0)
    feed, small = _dense_feed(rng), _dense_feed(rng, rows=4)
    counts = []
    exe.run(m['startup'], scope=scope)
    counts.append(exe.compile_count)
    for fetch in ([m['loss']], [m['loss']], [m['loss'], m['pred']]):
        exe.run(m['main'], feed=feed, fetch_list=fetch, scope=scope)
        counts.append(exe.compile_count)
    # a new op after a run: a new program version
    with fluid.program_guard(m['main'], m['startup']):
        fluid.layers.scale(m['pred'], scale=2.0)
    exe.run(m['main'], feed=feed, fetch_list=[m['loss']], scope=scope)
    counts.append(exe.compile_count)
    exe.run(m['main'], feed=small, fetch_list=[m['loss']], scope=scope)
    counts.append(exe.compile_count)
    other = fluid.Scope()
    exe.run(m['startup'], scope=other)
    exe.run(m['main'], feed=feed, fetch_list=[m['loss']], scope=other)
    counts.append(exe.compile_count)
    cached = len(exe._cache)
    del other
    gc.collect()
    counts.append((cached, len(exe._cache)))
    exe.run(m['main'], feed=feed, fetch_list=[m['loss']], scope=scope)
    counts.append(exe.compile_count)
    # the multi-step entry points count each new step count and stacked
    # feed signature as the JAX package compiles one executable for each
    exe.run_multi(m['main'], feed=feed, fetch_list=[m['loss']], steps=3,
                  scope=scope)
    counts.append(exe.compile_count)
    exe.run_multi(m['main'], feed=feed, fetch_list=[m['loss']], steps=3,
                  scope=scope)
    counts.append(exe.compile_count)
    exe.run_multi(m['main'], feed_list=[feed, feed], fetch_list=[m['loss']],
                  scope=scope)
    counts.append(exe.compile_count)
    exe.run_eval_multi(m['main'], feed_list=[feed, feed],
                       fetch_list=[m['loss']], scope=scope)
    counts.append(exe.compile_count)
    exe.run_eval_multi(m['main'], feed=feed, steps=2,
                       fetch_list=[m['loss']], scope=scope)
    counts.append(exe.compile_count)
    return counts


def test_compile_count_matches_jax():
    got = _count_sequence(tfluid)
    want = _count_sequence(jfluid)
    assert got == want
    # the sequence exercises every kind of miss: startup, main, hit, new
    # fetch list, new version, new feed shape, new scope (startup and
    # main), purge on the scope's death, multi-step compiles
    assert want[:8] == [1, 2, 2, 3, 4, 5, 7, (7, 5)], want


def test_minimize_after_a_forward_run_recompiles():
    """A program run forward and then built onto (minimize) runs its new op
    list: from the same state it trains exactly as the same program built
    with minimize from the start."""
    rng = np.random.RandomState(1)
    feed = _dense_feed(rng)
    grown = _mlp(tfluid, train=False)
    built = _mlp(tfluid, train=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope, ref_scope = tfluid.Scope(), tfluid.Scope()
    exe.run(built['startup'], scope=ref_scope)
    state = {v.name: ref_scope.find_var(v.name).value().numpy()
             for v in built['main'].list_vars() if v.persistable}
    tfluid.persistables_from_numpy(
        grown['main'], {n: state[n] for n in state
                        if grown['main'].global_block().has_var(n)},
        scope=scope, place=tfluid.CPUPlace())
    first, = exe.run(grown['main'], feed=feed, fetch_list=[grown['loss']],
                     scope=scope)
    count = exe.compile_count
    with tfluid.unique_name.guard(), \
            tfluid.program_guard(grown['main'], grown['startup']):
        tfluid.optimizer.SGD(0.5).minimize(grown['loss'])
    tfluid.persistables_from_numpy(grown['main'], state, scope=scope,
                                   place=tfluid.CPUPlace())
    got = [exe.run(grown['main'], feed=feed, fetch_list=[grown['loss']],
                   scope=scope)[0] for _ in range(3)]
    assert exe.compile_count == count + 1  # a new version of the program
    want = [exe.run(built['main'], feed=feed, fetch_list=[built['loss']],
                    scope=ref_scope)[0] for _ in range(3)]
    np.testing.assert_array_equal(first, want[0])
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    assert got[2][0] < got[1][0] < got[0][0]  # the appended SGD ran


_MUTATIONS = {
    'create_var': lambda p, b, op: b.create_var(name='v_new', shape=[1]),
    'create_parameter': lambda p, b, op: b.create_parameter(
        name='p_new', shape=[2], dtype='float32'),
    'append_op': lambda p, b, op: b.append_op(
        type='scale', inputs={'X': 'x'}, outputs={'Out': 'y'}),
    'prepend_op': lambda p, b, op: b._prepend_op(
        type='scale', inputs={'X': 'x'}, outputs={'Out': 'y'}),
    'insert_op': lambda p, b, op: b._insert_op(
        0, type='scale', inputs={'X': 'x'}, outputs={'Out': 'y'}),
    'remove_op': lambda p, b, op: b._remove_op(0),
    'set_attr': lambda p, b, op: op._set_attr('scale', 3.0),
    'rename_input': lambda p, b, op: op.rename_input('x', 'x2'),
    'rename_output': lambda p, b, op: op.rename_output('y', 'y2'),
}


@pytest.mark.parametrize('mutation', sorted(_MUTATIONS))
def test_every_program_mutation_bumps_the_version(mutation):
    bumps = {}
    for name, fluid in BOTH:
        prog = fluid.Program()
        block = prog.global_block()
        op = block.append_op(type='scale', inputs={'X': 'x'},
                             outputs={'Out': 'y'}, attrs={'scale': 2.0})
        before = prog._version
        _MUTATIONS[mutation](prog, block, op)
        bumps[name] = prog._version - before
    assert bumps == {'jax': 1, 'torch': 1}


def test_assign_value_reads_its_values_after_set_attr():
    """An assign_value op whose values are replaced after a run yields the
    new values at the next run, in both packages."""
    got = {}
    for name, fluid in BOTH:
        prog = fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(prog):
            out = fluid.layers.assign(np.arange(6, dtype='float32').reshape(
                2, 3))
        exe, scope = fluid.Executor(_place(fluid)), fluid.Scope()
        first, = exe.run(prog, fetch_list=[out], scope=scope)
        op, = [o for o in prog.global_block().ops
               if o.type == 'assign_value']
        op.set_attr('values', -np.arange(6, dtype='float32').reshape(2, 3))
        second, = exe.run(prog, fetch_list=[out], scope=scope)
        got[name] = (np.asarray(first), np.asarray(second), exe.compile_count)
    want = np.arange(6, dtype='float32').reshape(2, 3)
    for name in got:
        np.testing.assert_array_equal(got[name][0], want)
        np.testing.assert_array_equal(got[name][1], -want)
    assert got['torch'][2] == got['jax'][2] == 2


def test_lru_keeps_64_blocks():
    m = _mlp(tfluid, train=False)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(m['startup'], scope=scope)
    rng = np.random.RandomState(2)
    for rows in range(1, 66):
        exe.run(m['main'], feed=_dense_feed(rng, rows=rows),
                fetch_list=[m['loss']], scope=scope)
    assert len(exe._cache) == exe._CACHE_MAX == 64
    count = exe.compile_count
    exe.run(m['main'], feed=_dense_feed(rng, rows=65),
            fetch_list=[m['loss']], scope=scope)
    assert exe.compile_count == count  # the newest is kept
    exe.run(m['main'], feed=_dense_feed(rng, rows=1),
            fetch_list=[m['loss']], scope=scope)
    # the oldest two (the startup program's and rows=1) were evicted
    assert exe.compile_count == count + 1


def test_block_mode_and_capture_declarations():
    m = _mlp(tfluid, train=False)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(m['startup'], scope=scope)
    exe.run(m['main'], feed=_dense_feed(np.random.RandomState(3)),
            fetch_list=[m['loss']], scope=scope)
    block = list(exe._cache.values())[-1]
    assert (block.mode, block.why, block.refusal) == ('eager', 'CPU place',
                                                       None)
    assert block.last_ran == 'eager'
    prog = _reshape_by_shape(tfluid)[0]
    op = [o for o in prog.global_block().ops if o.type == 'reshape'][0]
    assert 'Shape input on the host' in tregistry.capture_refusal(op)
    # a random op with a seed of its own; without one it is capturable
    block = tfluid.Program().global_block()
    seeded = block.append_op(type='uniform_random', outputs={'Out': 'u'},
                             attrs={'shape': [3], 'seed': 7})
    drawn = block.append_op(type='uniform_random', outputs={'Out': 'v'},
                            attrs={'shape': [3], 'seed': 0})
    assert 'generator of its own' in tregistry.capture_refusal(seeded)
    assert tregistry.capture_refusal(drawn) is None


def _reshape_by_shape(fluid):
    """A block a capture cannot hold: reshape with a Shape input (the
    port reads it on the host) before a trainable fc."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data('x', [4])
        shape = fluid.layers.fill_constant([2], 'int32', 0)
        y = fluid.layers.reshape(x, [-1, 4], actual_shape=shape)
        loss = fluid.layers.mean(fluid.layers.fc(y, 3))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, loss


# ----------------------------------------------------------------------------
# run_multi
# ----------------------------------------------------------------------------
def _mlp_batches(rng, k):
    return [_dense_feed(rng) for _ in range(k)]


def _lod_batches(rng, k):
    return [_lod_feed(tfluid, rng) for _ in range(k)]


def _lstm_batches(rng, k):
    # lengths 3-14: one T bucket
    return [_lod_feed(tfluid, rng, rows=4, vocab=40, label=True)
            for _ in range(k)]


_MULTI = {
    # case: (model, batches, feed=one batch or feed_list, steps, Adam's lr
    # or None)
    'feed_mlp': (_mlp, _mlp_batches, 'feed', 5, None),
    'single_step_mlp': (_mlp, _mlp_batches, 'feed', 1, None),
    'feed_list_mlp': (_mlp, _mlp_batches, 'feed_list', 6, None),
    'feed_mnist_mlp': (_mnist_mlp, lambda r, k: [_mnist_feed(r)], 'feed', 3,
                       0.01),
    'feed_list_lod': (_lod_net, _lod_batches, 'feed_list', 4, None),
    'feed_list_stacked_lstm': (_stacked_lstm, _lstm_batches, 'feed_list', 3,
                               0.01),
}


def _check_params(got, want, adam_lr, steps):
    if adam_lr is None:
        np.testing.assert_allclose(got, want, atol=TOL)
        return
    diff = np.abs(got - want)
    assert diff.max() <= 2 * adam_lr * steps
    assert (diff > TOL).mean() <= 1e-3


@pytest.mark.parametrize('case', sorted(_MULTI))
def test_run_multi_matches_jax_and_sequential_runs(case):
    build, batches, form, steps, adam_lr = _MULTI[case]
    pair = Pair(build)
    rng = np.random.RandomState(4)
    feeds = batches(rng, steps)
    tm, jm = pair.m['torch'], pair.m['jax']
    args = lambda name: (
        dict(feed=pair.feed(name, feeds[0]), steps=steps) if form == 'feed'
        else dict(feed_list=[pair.feed(name, f) for f in feeds]))
    jout, = pair.jexe.run_multi(jm['main'], fetch_list=[jm['loss']],
                                scope=pair.jscope, **args('jax'))
    tout, = pair.texe.run_multi(tm['main'], fetch_list=[tm['loss']],
                                scope=pair.tscope, **args('torch'))
    np.testing.assert_allclose(tout, jout, atol=TOL)
    # the port's K sequential runs from the same start, in a scope of its own
    seq_scope = tfluid.Scope()
    pair.handover(seq_scope)
    exe = tfluid.Executor(tfluid.CPUPlace())
    for i in range(steps):
        sout, = exe.run(tm['main'], feed=feeds[i if form == 'feed_list'
                                               else 0],
                        fetch_list=[tm['loss']], scope=seq_scope)
    np.testing.assert_array_equal(tout, sout)
    for p in tm['main'].all_parameters():
        got = pair.tscope.find_var(p.name).value().numpy()
        np.testing.assert_array_equal(
            got, seq_scope.find_var(p.name).value().numpy())
        _check_params(got, np.asarray(pair.jscope.find_var(p.name).value()),
                      adam_lr, steps)
    # the state persisted: one more step keeps training
    nxt, = pair.texe.run(tm['main'], feed=feeds[-1], fetch_list=[tm['loss']],
                         scope=pair.tscope)
    assert np.isfinite(nxt).all()


# ----------------------------------------------------------------------------
# run_eval_multi
# ----------------------------------------------------------------------------
def _eval_lots(kind, rng):
    lot = lambda rows=4, lo=3, hi=15: _lod_feed(tfluid, rng, rows=rows, lo=lo,
                                                hi=hi, vocab=40, label=True)
    if kind == 'equal':
        return [lot() for _ in range(3)]
    if kind == 'trailing':  # lots padded to T 16 and T 32
        return [lot(), lot(lo=17, hi=30), lot()]
    # 'rows': the last lot is short, padded to 4 rows and trimmed
    return [lot(), lot(), lot(rows=2)]


@pytest.fixture(scope='module')
def lstm_pair():
    """The tiny stacked LSTM in both packages; the tests that share it run
    its test program, which writes no state."""
    return Pair(_stacked_lstm)


@pytest.mark.parametrize('kind', ['equal', 'trailing', 'rows'])
def test_run_eval_multi_matches_jax(kind, lstm_pair):
    pair = lstm_pair
    lots = _eval_lots(kind, np.random.RandomState(5))
    tm, jm = pair.m['torch'], pair.m['jax']
    out = {}
    for name, exe, m, scope in (('jax', pair.jexe, jm, pair.jscope),
                                ('torch', pair.texe, tm, pair.tscope)):
        out[name] = exe.run_eval_multi(
            m['test'], feed_list=[pair.feed(name, f) for f in lots],
            fetch_list=[m['pred']], scope=scope)
    got, want = out['torch'][0], out['jax'][0]
    if kind == 'rows':  # unequal real rows: a list of K trimmed arrays
        assert [g.shape for g in got] == [w.shape for w in want] == \
            [(4, 2), (4, 2), (2, 2)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=TOL)
    else:
        assert got.shape == want.shape == (3, 4, 2)
        np.testing.assert_allclose(got, want, atol=TOL)
    # every lot against its own run() in the port
    for i, lot in enumerate(lots):
        one, = pair.texe.run(tm['test'], feed=lot, fetch_list=[tm['pred']],
                             scope=pair.tscope)
        np.testing.assert_allclose(got[i], one, atol=TOL)


def test_run_eval_multi_masks_the_padding_rows_in_a_mean():
    """A mean over a short lot's padded rows counts its real rows only, as
    the JAX package's sample mask makes it."""
    lots = [_dense_feed(np.random.RandomState(6), rows=r) for r in (8, 5)]
    pair = Pair(lambda fluid: _mlp(fluid, train=False))
    out = {}
    for name, exe, scope in (('jax', pair.jexe, pair.jscope),
                             ('torch', pair.texe, pair.tscope)):
        m = pair.m[name]
        out[name] = exe.run_eval_multi(m['main'], feed_list=lots,
                                       fetch_list=[m['loss'], m['pred']],
                                       scope=scope)
    loss, pred = out['torch']
    np.testing.assert_allclose(loss, out['jax'][0], atol=TOL)
    assert [p.shape for p in pred] == [(8, 3), (5, 3)]
    one, = pair.texe.run(pair.m['torch']['main'], feed=lots[1],
                         fetch_list=[pair.m['torch']['loss']],
                         scope=pair.tscope)
    np.testing.assert_allclose(loss[1], one, atol=TOL)


# ----------------------------------------------------------------------------
# errors
# ----------------------------------------------------------------------------
def _errors():
    rng = np.random.RandomState(7)
    feed, small = _dense_feed(rng), _dense_feed(rng, rows=4)
    return {
        'run_multi_steps_0': ('run_multi', dict(feed=feed, steps=0),
                              ValueError, 'steps must be >= 1'),
        'run_multi_mixed_shapes': ('run_multi', dict(feed_list=[feed, small]),
                                   ValueError, 'shape'),
        'run_multi_feed_and_feed_list': (
            'run_multi', dict(feed=feed, feed_list=[feed]), ValueError,
            'feed OR feed_list'),
        # a reader the program does not read, as the JAX package refuses it
        'run_multi_reader': ('run_multi', dict(reader=object(), steps=2),
                             RuntimeError, 'no read op consuming reader'),
        'run_multi_embed_caches': (
            'run_multi', dict(feed=feed, embed_caches=[object()]),
            NotImplementedError, 'ROADMAP.md'),
        'run_eval_multi_steps_0': ('run_eval_multi', dict(feed=feed, steps=0),
                                   ValueError, 'steps must be >= 1'),
        'run_eval_multi_no_steps': ('run_eval_multi', dict(feed=feed),
                                    ValueError, 'pass steps='),
        'run_eval_multi_empty': ('run_eval_multi', dict(feed_list=[]),
                                 ValueError, 'empty'),
        'run_eval_multi_feed_and_feed_list': (
            'run_eval_multi', dict(feed=feed, feed_list=[feed]), ValueError,
            'feed OR feed_list'),
        'run_eval_multi_reader': (
            'run_eval_multi', dict(reader=object(), steps=2),
            RuntimeError, 'no read op consuming reader'),
    }


@pytest.mark.parametrize('case', sorted(_errors()))
def test_multi_step_errors(case):
    method, kwargs, exc, match = _errors()[case]
    m = _mlp(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(m['startup'], scope=scope)
    with pytest.raises(exc, match=match):
        getattr(exe, method)(m['main'], fetch_list=[m['loss']], scope=scope,
                             **kwargs)


@pytest.mark.parametrize('method', ['run_multi', 'run_eval_multi'])
def test_multi_step_rejects_an_uncapturable_block(method):
    """As the JAX package rejects a block with a host op."""
    prog, startup, loss = _reshape_by_shape(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {'x': np.ones((8, 4), 'float32')}
    one, = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(one).all()  # run() runs it, eagerly
    with pytest.raises(RuntimeError, match='cannot be captured'):
        getattr(exe, method)(prog, feed=feed, fetch_list=[loss], steps=2,
                             scope=scope)


# ----------------------------------------------------------------------------
# state handed over between runs
# ----------------------------------------------------------------------------
def test_a_parameter_replaced_between_runs_is_read():
    pair = Pair(lambda fluid: _mlp(fluid, train=False))
    tm, jm = pair.m['torch'], pair.m['jax']
    feed = _dense_feed(np.random.RandomState(8))
    first, = pair.texe.run(tm['main'], feed=feed, fetch_list=[tm['pred']],
                           scope=pair.tscope)
    # new parameters on both sides, handed to the port's scope
    rng = np.random.RandomState(9)
    for p in jm['main'].all_parameters():
        v = np.asarray(pair.jscope.find_var(p.name).value())
        pair.jscope.find_var(p.name).set_value(
            (v + 0.5 * rng.standard_normal(v.shape)).astype(v.dtype))
    tfluid.params_from_numpy(
        tm['main'], {p.name: np.asarray(pair.jscope.find_var(p.name).value())
                     for p in jm['main'].all_parameters()},
        scope=pair.tscope, place=tfluid.CPUPlace())
    second, = pair.texe.run(tm['main'], feed=feed, fetch_list=[tm['pred']],
                            scope=pair.tscope)
    want, = pair.jexe.run(jm['main'], feed=feed, fetch_list=[jm['pred']],
                          scope=pair.jscope)
    assert pair.texe.compile_count == 1  # one block, read twice
    assert np.abs(second - first).max() > 1e-3
    np.testing.assert_allclose(second, want, atol=TOL)


def test_feed_list_helpers_pad_and_stack():
    """normalize_trailing_feed_list pads the time axis to one bucket;
    stack_steps stacks on a new K axis; prepare_feed_list returns the lots
    uniform."""
    rng = np.random.RandomState(10)
    lots = [_lod_feed(tfluid, rng, lo=3, hi=15),
            _lod_feed(tfluid, rng, lo=17, hi=30)]
    steps, per_step = texecutor.prepare_feed_list(lots)
    assert steps == 2
    assert [tuple(fa['words'].shape) for fa in per_step] == [(4, 32, 1)] * 2
    stacked = texecutor.stack_steps([fa['words'] for fa in per_step])
    assert tuple(stacked.shape) == (2, 4, 32, 1)
    assert texecutor.feed_signature(per_step[0]) == \
        texecutor.feed_signature(per_step[1])
