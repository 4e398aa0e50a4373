"""The PyTorch port's CTR slice held against the JAX package on the CPU: the
new lowerings (``cast``, ``concat``, ``sigmoid_cross_entropy_with_logits``)
one-op with their generic grads, sparse gradients (``SparseRows``,
``merge_rows``, ``lookup_table``'s ``is_sparse`` grad fetched as a
``SelectedRows``, ``sum`` and ``scale`` over sparse parts), the lazy
row-subset SGD/Momentum/Adam and ``lazy_apply``, ``ctr.build()`` and
``word2vec.build()`` ProgramDescs, CTR trained three Adam steps in its sparse
and dense forms, and ``run_multi`` of sparse steps.

Sizes: vocabulary 1000, embedding 8, hidden (16, 8), batches of 64 rows
from ``zipf_batch`` (row 0 is hot, so ids repeat); state handed over from
the JAX scope by ``persistables_from_numpy``.

Tolerances:
- one-op forwards and grads, ``merge_rows``' sums, sparse gradient values:
  1e-5 relative and absolute (the same f32 arithmetic up to summation
  order; ``merge_rows`` sums a hot id's 100-odd values in another order);
- CTR training: the loss 1e-5 relative; each gradient within 1e-5 of its
  own max|g|; every persistable var after each step 1e-5 relative and
  absolute (Adam's step is lr = 1e-3 a row, so 1e-5 is a hundredth of
  one step);
- sparse against dense in one package: bitwise where one lookup feeds
  the table (both lanes merge a repeated id's rows alike); 1e-6 absolute
  where two lookups do (the dense lane sums their merged gradients, the
  sparse lane merges all their rows at once);
- lazy Adam's untouched rows, and Adam's untouched moments: bitwise;
- ``run_multi`` against ``run`` calls in the port: bitwise (one CPU path).
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import ctr as jax_ctr
from paddle_tpu.models import word2vec as jax_word2vec
from paddle_tpu.ops import sparse as jsparse

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.dataset import ctr as ctr_data
from paddle_tpu_torch.models import ctr as torch_ctr
from paddle_tpu_torch.models import word2vec as torch_word2vec
from paddle_tpu_torch.ops import registry as tregistry
from paddle_tpu_torch.ops import sparse as tsparse

from test_torch_cv_ops import build_both

TOL = 1e-5
SMALL = dict(sparse_dim=1000, embed_size=8, hidden_sizes=(16, 8), lr=1e-3)
BATCH = 64


# ---- one-op lowerings and their generic grads ----

def _one_op(fluid, op_type, inputs, outputs, attrs, grad_of=None, wrt=(),
            cot=None):
    """Run one op (``inputs`` {slot: [(name, array), ...]}, ``outputs``
    {slot: name}), with ``grad_of`` its output ``grad_of``'s cotangent
    ``cot`` fed; fetch its outputs and the gradients of ``wrt``."""
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        blk = prog.global_block()
        feed = {}
        for pairs in inputs.values():
            for name, arr in pairs:
                blk.create_var(name=name, shape=arr.shape,
                               dtype=str(arr.dtype))
                feed[name] = arr
        for name in outputs.values():
            blk.create_var(name=name, dtype='float32')
        blk.append_op(type=op_type,
                      inputs={s: [n for n, _ in p] for s, p in inputs.items()},
                      outputs={s: [n] for s, n in outputs.items()},
                      attrs=attrs)
        fetch = list(outputs.values())
        if grad_of is not None:
            cvar = blk.create_var(name='cot', shape=cot.shape,
                                  dtype='float32')
            feed['cot'] = cot
            fluid.backward.calc_gradient(
                targets=[blk.var(outputs[grad_of])],
                inputs=[blk.var(n) for n in wrt], target_gradients=[cvar])
            fetch += [n + '@GRAD' for n in wrt]
    out = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch, scope=fluid.Scope())
    return [np.asarray(o) for o in out]


def _compare(op_type, inputs, outputs, attrs, grad_of=None, wrt=()):
    cot = None
    if grad_of is not None:
        shape = _one_op(jfluid, op_type, inputs, outputs, attrs)[
            list(outputs).index(grad_of)].shape
        cot = np.random.RandomState(8).standard_normal(shape).astype(
            'float32')
    want = _one_op(jfluid, op_type, inputs, outputs, attrs, grad_of, wrt, cot)
    got = _one_op(tfluid, op_type, inputs, outputs, attrs, grad_of, wrt, cot)
    names = list(outputs.values()) + [n + '@GRAD' for n in wrt]
    for name, w, g in zip(names, want, got):
        assert g.shape == w.shape, name
        if name.endswith('@GRAD'):
            assert np.abs(w).max() > 0, name
        # the JAX package runs with x64 off: compare values, not int widths
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   rtol=TOL, atol=TOL, err_msg=name)
    return got


_F32 = np.random.RandomState(5).standard_normal((4, 6)).astype('float32')


@pytest.mark.parametrize('case', ['int64_to_float32', 'float32_to_int32',
                                  'float32_to_float32'])
def test_cast_matches_jax(case):
    src, dst = case.split('_to_')
    x = (np.random.RandomState(6).randint(-5, 5, (4, 6)).astype(src)
         if src == 'int64' else _F32 * 3)
    grad = dict(grad_of='Out', wrt=['x']) if dst == 'float32' and \
        src == 'float32' else {}
    got = _compare('cast', {'X': [('x', x)]}, {'Out': 'out'},
                   {'in_dtype': src, 'out_dtype': dst}, **grad)
    assert got[0].dtype == np.dtype(dst)


@pytest.mark.parametrize('axis', [0, 1, -1])
def test_concat_matches_jax(axis):
    rng = np.random.RandomState(7)
    if axis == 0:
        shapes = [(2, 5), (3, 5), (1, 5)]
    else:
        shapes = [(3, 2), (3, 7), (3, 1)]
    xs = [('x%d' % i, rng.standard_normal(s).astype('float32'))
          for i, s in enumerate(shapes)]
    _compare('concat', {'X': xs}, {'Out': 'out'}, {'axis': axis},
             grad_of='Out', wrt=[n for n, _ in xs])


def test_sigmoid_cross_entropy_with_logits_matches_jax():
    """Large logits of both signs (the stable form), soft labels in [0, 1];
    the gradient of X and of the float Label."""
    rng = np.random.RandomState(9)
    x = (rng.standard_normal((6, 3)) * 8).astype('float32')
    x[0, 0], x[1, 1] = 90.0, -90.0
    label = rng.uniform(0, 1, (6, 3)).astype('float32')
    label[:, 2] = np.round(label[:, 2])
    got = _compare('sigmoid_cross_entropy_with_logits',
                   {'X': [('x', x)], 'Label': [('label', label)]},
                   {'Out': 'out'}, {}, grad_of='Out', wrt=['x', 'label'])
    assert np.isfinite(got[0]).all()


def test_the_ctr_lowerings_are_registered():
    for op in ('cast', 'concat', 'sigmoid_cross_entropy_with_logits'):
        assert op in tregistry._LOWERINGS
    assert tregistry.get_lowering('lookup_table_grad') is \
        tsparse._lookup_table_grad


# ---- SparseRows and merge_rows ----

def _ids(case):
    rng = np.random.RandomState(11)
    if case == 'zipf':
        return ctr_data.zipf_batch(rng, 8, 50)['sparse_ids'].reshape(-1)
    if case == 'all_equal':
        return np.full((12, ), 7, 'int64')
    if case == 'distinct':
        return rng.permutation(50)[:12].astype('int64')
    return np.array([3], 'int64')


@pytest.mark.parametrize('case', ['zipf', 'all_equal', 'distinct', 'one'])
def test_merge_rows_matches_jax(case):
    import jax.numpy as jnp
    ids = _ids(case)
    vals = np.random.RandomState(12).standard_normal(
        (len(ids), 5)).astype('float32')
    w_rows, w_vals = jsparse.merge_rows(jnp.asarray(ids), jnp.asarray(vals),
                                        50)
    g_rows, g_vals = tsparse.merge_rows(torch.from_numpy(ids),
                                        torch.from_numpy(vals), 50)
    np.testing.assert_array_equal(g_rows.numpy(), np.asarray(w_rows))
    np.testing.assert_allclose(g_vals.numpy(), np.asarray(w_vals), rtol=TOL,
                               atol=TOL)
    uniq = np.unique(ids)
    assert (g_rows.numpy()[:len(uniq)] == uniq).all()
    assert (g_rows.numpy()[len(uniq):] == 50).all()
    assert not g_vals.numpy()[len(uniq):].any()


def test_scatter_rows_skips_the_sentinel_slots():
    """The leftover slots of merge_rows write slot 0's value onto slot 0's
    row: only the touched rows change."""
    ids = torch.tensor([4, 9, 4, 4, 1])
    rows, _ = tsparse.merge_rows(ids, torch.ones(5, 2), 10)
    table = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    new = -torch.arange(10, dtype=torch.float32).reshape(5, 2) - 1
    out = tsparse._scatter_rows(table.clone(), rows, new)
    want = table.clone()
    want[[1, 4, 9]] = new[:3]
    assert torch.equal(out, want)
    assert torch.equal(tsparse._gather_rows(table, rows)[3:],
                       table[[9, 9]])


def test_sparse_rows_methods_match_jax():
    import jax.numpy as jnp
    ids = _ids('zipf')[:10]
    vals = np.random.RandomState(13).standard_normal((10, 3)).astype(
        'float32')
    j = jsparse.SparseRows(jnp.asarray(ids), jnp.asarray(vals), 50)
    t = tsparse.SparseRows(torch.from_numpy(ids), torch.from_numpy(vals), 50)
    assert t.dense_shape == j.dense_shape == (50, 3)
    np.testing.assert_allclose(t.to_dense().numpy(), np.asarray(j.to_dense()),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(t.touched_mask().numpy(),
                                  np.asarray(j.touched_mask()))
    np.testing.assert_allclose(t.scale(0.5).values.numpy(),
                               np.asarray(j.scale(0.5).values))
    dense = np.random.RandomState(14).standard_normal((50, 3)).astype(
        'float32')
    both = tsparse.sparse_add(t, t.scale(2.0))
    assert isinstance(both, tsparse.SparseRows) and both.rows.shape == (20, )
    np.testing.assert_allclose(both.to_dense().numpy(),
                               3 * t.to_dense().numpy(), rtol=TOL, atol=TOL)
    for got in (tsparse.sparse_add(torch.from_numpy(dense), t),
                tsparse.sparse_add(t, torch.from_numpy(dense))):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jsparse.sparse_add(jnp.asarray(dense), j)),
            rtol=TOL, atol=TOL)


def _run_lowering(op_type, inputs, outputs, attrs):
    """One lowering called directly on ``inputs`` {slot: (name, value)}
    (a SparseRows value cannot be fed): the context's env after it."""
    prog = tfluid.Program()
    blk = prog.global_block()
    for name, _ in inputs.values():
        blk.create_var(name=name, dtype='float32')
    for name in outputs.values():
        blk.create_var(name=name, dtype='float32')
    op = blk.append_op(type=op_type,
                       inputs={s: [n] for s, (n, _) in inputs.items()},
                       outputs={s: [n] for s, n in outputs.items()},
                       attrs=attrs)
    env = {n: v for n, v in inputs.values()}
    ctx = tregistry.LoweringContext(blk, env, tfluid.CPUPlace())
    tregistry.get_lowering(op_type)(ctx, op)
    return env


def test_scale_of_sparse_rows():
    g = tsparse.SparseRows(torch.tensor([1, 3, 1]), torch.ones(3, 2), 5)
    env = _run_lowering('scale', {'X': ('g', g)}, {'Out': 'out'},
                        {'scale': 0.25, 'bias': 0.0})
    out = env['out']
    assert isinstance(out, tsparse.SparseRows) and out.height == 5
    assert torch.equal(out.values, torch.full((3, 2), 0.25))
    with pytest.raises(NotImplementedError, match='bias'):
        _run_lowering('scale', {'X': ('g', g)}, {'Out': 'out'},
                      {'scale': 1.0, 'bias': 1.0})


# ---- lookup_table's sparse grad, and the lazy optimizers ----

def _embedding_prog(fluid, is_sparse, optimizer, shared=False, vocab=50,
                    dim=4):
    """tests/test_sparse.py's program: one or two lookups of one table,
    loss = mean(sum(x^2))."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name='ids', shape=[3], dtype='int64')
        feats = [fluid.layers.embedding(
            ids, size=[vocab, dim], is_sparse=is_sparse,
            param_attr=fluid.ParamAttr(name='emb_w'))]
        if shared:
            ids2 = fluid.layers.data(name='ids2', shape=[2], dtype='int64')
            feats.append(fluid.layers.embedding(
                ids2, size=[vocab, dim], is_sparse=is_sparse,
                param_attr=fluid.ParamAttr(name='emb_w')))
        flat = fluid.layers.concat(
            [fluid.layers.reshape(f, shape=[0, -1]) for f in feats], axis=1)
        loss = fluid.layers.mean(fluid.layers.reduce_sum(
            fluid.layers.elementwise_mul(flat, flat), dim=-1))
        optimizer(fluid).minimize(loss)
    return main, startup, loss


def _emb_feed(rng, shared):
    feed = {'ids': rng.randint(0, 12, (8, 3)).astype('int64')}
    feed['ids'][:, 0] = 2  # a hot row
    if shared:
        feed['ids2'] = rng.randint(0, 12, (8, 2)).astype('int64')
    return feed


_OPTIMIZERS = {
    'sgd': lambda fluid: fluid.optimizer.SGD(0.1),
    'momentum': lambda fluid: fluid.optimizer.Momentum(0.1, momentum=0.9),
    'nesterov': lambda fluid: fluid.optimizer.Momentum(
        0.1, momentum=0.9, use_nesterov=True),
    'adam': lambda fluid: fluid.optimizer.Adam(0.05),
}


def _emb_pair(is_sparse, opt, shared=False):
    """The embedding program in both packages from the JAX startup's
    state: (jax main, jax scope, jax exe, port main, port scope, port exe,
    loss, state names)."""
    jmain, jstart, jloss = _embedding_prog(jfluid, is_sparse,
                                           _OPTIMIZERS[opt], shared)
    tmain, _, _ = _embedding_prog(tfluid, is_sparse, _OPTIMIZERS[opt],
                                  shared)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    state = [v.name for v in tmain.list_vars() if v.persistable]
    tscope = tfluid.Scope()
    tfluid.persistables_from_numpy(
        tmain, {n: np.asarray(jscope.find_var(n).value()) for n in state},
        scope=tscope, place=tfluid.CPUPlace())
    return (jmain, jscope, jexe, tmain, tscope,
            tfluid.Executor(tfluid.CPUPlace()), jloss.name, state)


def test_sparse_lookup_table_grad_is_a_selected_rows_equal_to_jax():
    """Two lookups of one table: each lookup's grad is a SparseRows, the
    backward's ``sum`` concatenates them, and the fetched ``emb_w@GRAD`` is
    a SelectedRows with the JAX package's rows, height and values."""
    jmain, jscope, jexe, tmain, tscope, texe, loss, _ = _emb_pair(
        True, 'sgd', shared=True)
    types = [op.type for op in tmain.global_block().ops]
    assert types.count('lookup_table_grad') == 2 and 'sum' in types
    feed = _emb_feed(np.random.RandomState(0), True)
    want, = jexe.run(jmain, feed=feed, fetch_list=['emb_w@GRAD'],
                     scope=jscope)
    got, = texe.run(tmain, feed=feed, fetch_list=['emb_w@GRAD'],
                    scope=tscope)
    assert isinstance(got, tfluid.core.SelectedRows)
    assert got.height() == want.height() == 50
    assert list(got.rows()) == [int(r) for r in want.rows()]
    assert len(got.rows()) == 8 * 3 + 8 * 2
    np.testing.assert_allclose(np.asarray(got.get_tensor()),
                               np.asarray(want.get_tensor()), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.to_dense(), want.to_dense(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize('opt', sorted(_OPTIMIZERS))
def test_sparse_optimizer_step_matches_jax(opt):
    """Two steps of each optimizer's row-subset update, a duplicated id in
    every batch: every persistable var against the JAX package's."""
    jmain, jscope, jexe, tmain, tscope, texe, loss, state = _emb_pair(
        True, opt)
    rng = np.random.RandomState(1)
    for step in range(2):
        feed = _emb_feed(rng, False)
        want, = jexe.run(jmain, feed=feed, fetch_list=[loss], scope=jscope)
        got, = texe.run(tmain, feed=feed, fetch_list=[loss], scope=tscope)
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL)
        for name in state:
            np.testing.assert_allclose(
                tscope.find_var(name).value().numpy(),
                np.asarray(jscope.find_var(name).value()), rtol=TOL,
                atol=TOL, err_msg='%s after step %d' % (name, step + 1))


def test_sparse_adam_is_lazy():
    """Untouched rows of the table and of both moments stay bitwise as they
    were; the touched rows move (``tests/test_sparse.py``'s check)."""
    _, _, _, tmain, tscope, texe, loss, _ = _emb_pair(True, 'adam')
    before = tscope.find_var('emb_w').value().numpy().copy()
    feed = {'ids': np.array([[1, 3, 3], [5, 1, 3]], 'int64')}
    table, = texe.run(tmain, feed=feed, fetch_list=['emb_w'], scope=tscope)
    touched = np.zeros(50, bool)
    touched[[1, 3, 5]] = True
    np.testing.assert_array_equal(table[~touched], before[~touched])
    assert (table[touched] != before[touched]).all()
    moments = [v.name for v in tmain.list_vars() if 'moment' in v.name]
    assert len(moments) == 2
    for name in moments:
        m = tscope.find_var(name).value().numpy()
        assert not m[~touched].any() and m[touched].all(), name
    # the fetch is the caller's: the next step does not write into it
    kept = table.copy()
    texe.run(tmain, feed=feed, fetch_list=[loss], scope=tscope)
    np.testing.assert_array_equal(table, kept)


@pytest.mark.parametrize('shared', [False, True])
def test_sparse_sgd_matches_dense(shared):
    """SGD: the sparse and dense forms stay equal over 3 steps (one table
    lookup, or two whose sparse grads sum)."""
    tables = []
    for is_sparse in (False, True):
        _, _, _, tmain, tscope, texe, loss, _ = _emb_pair(is_sparse, 'sgd',
                                                          shared)
        rng = np.random.RandomState(2)
        for _ in range(3):
            texe.run(tmain, feed=_emb_feed(rng, shared), fetch_list=[loss],
                     scope=tscope)
        tables.append(tscope.find_var('emb_w').value().numpy())
    if shared:
        np.testing.assert_allclose(tables[1], tables[0], rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(tables[1], tables[0])


def test_lazy_apply_matches_the_row_subset_adam():
    """``lazy_apply`` over the dense Adam lowering (the path of an optimizer
    with no row-subset update) against ``_rows_adam``: the same touched
    rows, untouched rows and moments bitwise unchanged."""
    rng = np.random.RandomState(15)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        'float32'))
    g = tsparse.SparseRows(torch.tensor([2, 7, 2, 0]), f32(4, 3), 9)
    p, m1, m2 = f32(9, 3), f32(9, 3), f32(9, 3).abs()
    scalars = {'lr': torch.tensor([0.01]), 'b1p': torch.tensor([0.9]),
               'b2p': torch.tensor([0.999])}
    outs = []
    for lower in (None, tsparse._rows_adam):
        inputs = {'Param': ('p', p.clone()), 'Grad': ('g', g),
                  'Moment1': ('m1', m1.clone()),
                  'Moment2': ('m2', m2.clone()),
                  'LearningRate': ('lr', scalars['lr']),
                  'Beta1Pow': ('b1p', scalars['b1p']),
                  'Beta2Pow': ('b2p', scalars['b2p'])}
        outputs = {'ParamOut': 'p', 'Moment1Out': 'm1', 'Moment2Out': 'm2'}
        attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}
        if lower is None:
            dense = tsparse._ROW_SUBSET_APPLY.pop('adam')
            try:  # the wrapper takes lazy_apply without a row update
                env = _run_lowering('adam', inputs, outputs, attrs)
            finally:
                tsparse._ROW_SUBSET_APPLY['adam'] = dense
        else:
            env = _run_lowering('adam', inputs, outputs, attrs)
        outs.append([env[n] for n in ('p', 'm1', 'm2')])
    touched = torch.zeros(9, dtype=torch.bool)
    touched[[0, 2, 7]] = True
    for (lazy, rows), before in zip(zip(*outs), (p, m1, m2)):
        assert torch.equal(lazy[~touched], before[~touched])
        assert torch.equal(rows[~touched], before[~touched])
        np.testing.assert_allclose(lazy.numpy(), rows.numpy(), rtol=TOL,
                                   atol=TOL)


# ---- CTR ----

def _ctr_pair(is_sparse, **kwargs):
    jm, tm = build_both(jax_ctr, torch_ctr, is_sparse=is_sparse,
                        **dict(SMALL, **kwargs))
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jm['startup'], scope=jscope)
    state = [v.name for v in tm['main'].list_vars() if v.persistable]
    tscope = tfluid.Scope()
    tfluid.persistables_from_numpy(
        tm['main'], {n: np.asarray(jscope.find_var(n).value())
                     for n in state}, scope=tscope, place=tfluid.CPUPlace())
    return jm, tm, jscope, jexe, tscope, tfluid.Executor(tfluid.CPUPlace()), \
        state


@pytest.mark.parametrize('is_sparse', [True, False])
def test_ctr_builds_the_jax_programs(is_sparse):
    """main, test and startup equal (``build_both``); the backward's op list
    after ``mean_grad`` is the JAX package's, with no ``cast_grad``."""
    jm, tm = build_both(jax_ctr, torch_ctr, is_sparse=is_sparse, **SMALL)
    ops = tm['main'].global_block().ops
    types = [op.type for op in ops]
    tail = types[types.index('mean_grad') + 1:]
    assert tail[:2] == ['sigmoid_cross_entropy_with_logits_grad',
                        'elementwise_add_grad']
    assert 'cast_grad' not in types
    assert tail[-14:] == ['concat_grad', 'reshape_grad',
                          'lookup_table_grad'] + ['adam'] * 9 + \
        ['scale'] * 2
    sce = [op for op in ops
           if op.type == 'sigmoid_cross_entropy_with_logits_grad'][0]
    assert sce.output('Label@GRAD') == ['cast_0.tmp_0@GRAD']
    concat = [op for op in ops if op.type == 'concat_grad'][0]
    assert concat.output('X@GRAD') == ['', 'reshape_0.tmp_0@GRAD']
    lookup = [op for op in ops if op.type == 'lookup_table'][0]
    assert lookup.attrs['is_sparse'] is is_sparse
    # bench_ctr's full width builds too (no state is made)
    build_both(jax_ctr, torch_ctr, sparse_dim=1000000, embed_size=64,
               hidden_sizes=(256, 128), lr=1e-3, is_sparse=is_sparse)


@pytest.mark.parametrize('is_sparse', [True, False])
def test_ctr_trains_like_jax(is_sparse):
    """Three Adam steps on zipf batches from the same state: the loss, every
    gradient (the table's as a SelectedRows or dense), then every
    persistable var; then the test program's prediction."""
    jm, tm, jscope, jexe, tscope, texe, state = _ctr_pair(is_sparse)
    params = [p.name for p in tm['main'].all_parameters()]
    fetch = [tm['loss'].name] + [p + '@GRAD' for p in params]
    rng = np.random.RandomState(16)
    for step in range(3):
        feed = ctr_data.zipf_batch(rng, BATCH, SMALL['sparse_dim'])
        want = jexe.run(jm['main'], feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tm['main'], feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=TOL)
        for name, w, g in zip(params, want[1:], got[1:]):
            if name == 'ctr_embedding':
                assert isinstance(g, tfluid.core.SelectedRows) is is_sparse
            if is_sparse and name == 'ctr_embedding':
                assert list(g.rows()) == [int(r) for r in w.rows()]
                w, g = w.to_dense(), g.to_dense()
            w = np.asarray(w)
            assert np.abs(g).max() > 0, name
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=TOL * np.abs(w).max(),
                                       err_msg='%s@GRAD' % name)
        for name in state:
            np.testing.assert_allclose(
                tscope.find_var(name).value().numpy(),
                np.asarray(jscope.find_var(name).value()), rtol=TOL,
                atol=TOL, err_msg='%s after step %d' % (name, step + 1))
    feed = ctr_data.zipf_batch(rng, BATCH, SMALL['sparse_dim'])
    want, = jexe.run(jm['test'], feed=feed, fetch_list=[jm['prediction']],
                     scope=jscope)
    got, = texe.run(tm['test'], feed=feed, fetch_list=[tm['prediction']],
                    scope=tscope)
    assert got.shape == (BATCH, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_ctr_sparse_and_dense_adam_agree_at_step_one():
    """From zero moments, one Adam step moves no untouched row in either
    form, and both merge a hot id's rows alike: the two tables are bitwise
    equal."""
    tables = []
    for is_sparse in (True, False):
        _, tm, _, _, tscope, texe, _ = _ctr_pair(is_sparse)
        before = tscope.find_var('ctr_embedding').value().numpy().copy()
        feed = ctr_data.zipf_batch(np.random.RandomState(17), BATCH,
                                   SMALL['sparse_dim'])
        texe.run(tm['main'], feed=feed, fetch_list=[tm['loss']],
                 scope=tscope)
        tables.append(tscope.find_var('ctr_embedding').value().numpy())
    touched = np.zeros(SMALL['sparse_dim'], bool)
    touched[np.unique(feed['sparse_ids'])] = True
    for table in tables:
        np.testing.assert_array_equal(table[~touched], before[~touched])
    np.testing.assert_array_equal(tables[0], tables[1])


def test_ctr_run_multi_matches_run_calls():
    """``run_multi`` of 4 sparse Adam steps on 4 batches against 4 ``run``
    calls from the same state (the port, bitwise), and against the JAX
    package's ``run_multi``."""
    jm, tm, jscope, jexe, tscope, texe, state = _ctr_pair(True)
    start = {n: tscope.find_var(n).value().clone() for n in state}
    rng = np.random.RandomState(18)
    feeds = [ctr_data.zipf_batch(rng, BATCH, SMALL['sparse_dim'])
             for _ in range(4)]
    for f in feeds:
        last, = texe.run(tm['main'], feed=f, fetch_list=[tm['loss']],
                         scope=tscope)
    after = {n: tscope.find_var(n).value().numpy().copy() for n in state}
    for n, v in start.items():
        tscope.var(n).set_value(v.clone())
    got, = texe.run_multi(tm['main'], feed_list=feeds,
                          fetch_list=[tm['loss']], scope=tscope)
    np.testing.assert_array_equal(got, last)
    for n in state:
        np.testing.assert_array_equal(tscope.find_var(n).value().numpy(),
                                      after[n], err_msg=n)
    want, = jexe.run_multi(jm['main'], feed_list=feeds,
                           fetch_list=[jm['loss']], scope=jscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL)
    for n in state:
        np.testing.assert_allclose(after[n],
                                   np.asarray(jscope.find_var(n).value()),
                                   rtol=TOL, atol=TOL, err_msg=n)


# ---- word2vec ----

W2V = dict(dict_size=200, embed_size=16, hidden_size=32, lr=0.1)


def _w2v_feed(rng, rows=16):
    feed = {n: rng.randint(0, W2V['dict_size'], (rows, 1)).astype('int64')
            for n in ('firstw', 'secondw', 'thirdw', 'forthw', 'nextw')}
    feed['thirdw'][:4] = feed['firstw'][:4]  # one id in two slots
    return feed


def test_word2vec_sparse_builds_and_steps_like_jax():
    """``build(is_sparse=True)``'s programs, and one SGD step: the four
    lookups' SparseRows summed by one ``sum`` op, fetched and applied."""
    jm, tm = build_both(jax_word2vec, torch_word2vec, is_sparse=True, **W2V)
    types = [op.type for op in tm['main'].global_block().ops]
    assert types[-10:] == ['lookup_table_grad'] * 4 + ['sum'] + ['sgd'] * 5
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jm['startup'], scope=jscope)
    state = [v.name for v in tm['main'].list_vars() if v.persistable]
    tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    tfluid.persistables_from_numpy(
        tm['main'], {n: np.asarray(jscope.find_var(n).value())
                     for n in state}, scope=tscope, place=tfluid.CPUPlace())
    feed = _w2v_feed(np.random.RandomState(19))
    fetch = [tm['loss'].name, 'shared_w@GRAD']
    want = jexe.run(jm['main'], feed=feed, fetch_list=fetch, scope=jscope)
    got = texe.run(tm['main'], feed=feed, fetch_list=fetch, scope=tscope)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=TOL)
    assert len(got[1].rows()) == 4 * 16
    np.testing.assert_allclose(got[1].to_dense(), want[1].to_dense(),
                               rtol=TOL, atol=TOL)
    for name in state:
        np.testing.assert_allclose(
            tscope.find_var(name).value().numpy(),
            np.asarray(jscope.find_var(name).value()), rtol=TOL, atol=TOL,
            err_msg=name)


def test_word2vec_sparse_sgd_matches_dense():
    tables = []
    for is_sparse in (False, True):
        with tfluid.unique_name.guard():
            tm = torch_word2vec.build(is_sparse=is_sparse, **W2V)
        tm['startup'].random_seed = 3
        tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        texe.run(tm['startup'], scope=tscope)
        rng = np.random.RandomState(20)
        for _ in range(3):
            texe.run(tm['main'], feed=_w2v_feed(rng), fetch_list=[tm['loss']],
                     scope=tscope)
        tables.append(tscope.find_var('shared_w').value().numpy())
    np.testing.assert_allclose(tables[1], tables[0], rtol=0, atol=1e-6)
