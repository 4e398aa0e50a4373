"""The PyTorch port's control flow held against the JAX package on the CPU:
the compare and logical ops, ``increment``, ``where_select``,
``fill_zeros_like``, ``is_empty``, ``split_lod_tensor`` /
``merge_lod_tensor``, ``lod_rank_table`` / ``reorder_lod_tensor_by_rank``,
each one-op against the JAX lowering (and its generic grad where it has
one); ``While`` unbounded and bounded (``max_trip_count``, its grad through
the generic ``torch.func.vjp``), tensor arrays written, read and fetched
(``core.LoDTensorArray``), ``conditional_block``'s blend and its rejection
of a read or fetch of a conditionally uninitialized var, ``IfElse``
routed, unrouted and mixed, trained one SGD step, ``Switch`` over a step
counter, and a host op (``Print``) in a branch refused by both packages.
Every program is built in both packages and its ProgramDesc (every block,
op, attr and var) must be the same.

Tolerance: 1e-5, relative and absolute, for every float output and
gradient (the same f32 arithmetic up to summation order); integer and bool
outputs are equal (the JAX package holds int64 as int32, so they are
compared by value).
"""

import os
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid

from test_torch_cv_ops import _forward, _grads

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TOL = 1e-5


def _attr(value):
    """An attr comparable across the packages: a block by its index, a list
    of blocks by theirs."""
    if hasattr(value, 'ops') and hasattr(value, 'parent_idx'):
        return 'block %d' % value.idx
    if isinstance(value, (list, tuple)) and value and \
            all(hasattr(v, 'ops') for v in value):
        return ['block %d' % v.idx for v in value]
    return repr(value)


def _desc(program):
    return [(blk.idx, blk.parent_idx,
             [(op.type, {k: list(v) for k, v in op.inputs.items()},
               {k: list(v) for k, v in op.outputs.items()},
               sorted((k, _attr(v)) for k, v in op.attrs.items()))
              for op in blk.ops],
             sorted((v.name, tuple(v.shape), v.dtype, v.lod_level,
                     v.persistable, v.type) for v in blk.vars.values()))
            for blk in program.blocks]


def _build(build):
    """``build(fluid)`` in each package (a dict with 'main', 'startup' and
    'fetch' names); their ProgramDescs equal."""
    with jfluid.unique_name.guard():
        jm = build(jfluid)
    with tfluid.unique_name.guard():
        tm = build(tfluid)
    for key in ('main', 'startup'):
        assert _desc(tm[key]) == _desc(jm[key]), key
    return jm, tm


def _run(fluid, m, feed, runs=1):
    """The startup program, then ``runs`` runs of main: each run's
    fetches, and main's block as the executor cached it."""
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(m['startup'], scope=scope)
    outs = [exe.run(m['main'], feed=feed, fetch_list=m['fetch'],
                    scope=scope) for _ in range(runs)]
    blocks = getattr(exe, 'cached_blocks', None)  # the port's
    return outs, blocks()[-1] if blocks else None


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind == 'f':
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=what)


def _both(build, feed=None, runs=1):
    """Build in both packages and run each: the port's runs' fetches (each
    held against the JAX package's) and its main block as cached."""
    jm, tm = _build(build)
    want, _ = _run(jfluid, jm, feed or {}, runs)
    got, block = _run(tfluid, tm, feed or {}, runs)
    for r, (g_run, w_run) in enumerate(zip(got, want)):
        for name, g, w in zip(tm['fetch'], g_run, w_run):
            _same(g, w, 'run %d: %s' % (r, name))
    return got, block


# ---- one-op lowerings ----

def _f32(rng, *shape):
    return rng.standard_normal(shape).astype('float32')


def _one_op_cases():
    rng = np.random.RandomState(0)
    x, y = _f32(rng, 3, 4), _f32(rng, 3, 4)
    y[0] = x[0]  # equal entries
    bx = rng.rand(3, 4) > 0.5
    by = rng.rand(3, 4) > 0.5
    cases = {}
    for op in ('less_than', 'less_equal', 'greater_than', 'greater_equal',
               'equal', 'not_equal'):
        cases[op] = (op, {'X': ('x', x), 'Y': ('y', y)}, {'Out': 'out'}, {})
    for op in ('logical_and', 'logical_or', 'logical_xor'):
        cases[op] = (op, {'X': ('x', bx), 'Y': ('y', by)}, {'Out': 'out'},
                     {})
    cases['logical_not'] = ('logical_not', {'X': ('x', bx)}, {'Out': 'out'},
                            {})
    cases['increment_f32'] = ('increment', {'X': ('x', x)}, {'Out': 'out'},
                              {'step': 2.5})
    cases['increment_int64'] = ('increment', {'X': (
        'x', np.array([7], 'int64'))}, {'Out': 'out'}, {'step': 3.0})
    for flag in (True, False):
        cases['where_select_%s' % flag] = (
            'where_select', {'Cond': ('c', np.array([flag])),
                             'X': ('x', x), 'Y': ('y', y)},
            {'Out': 'out'}, {})
    cases['fill_zeros_like'] = ('fill_zeros_like', {'X': ('x', x)},
                                {'Out': 'out'}, {})
    cases['is_empty'] = ('is_empty', {'X': ('x', x)}, {'Out': 'out'}, {})
    mask = np.array([[True], [False], [True], [True], [False]])
    rows = _f32(rng, 5, 3)
    cases['split_lod_tensor'] = (
        'split_lod_tensor', {'X': ('x', rows), 'Mask': ('m', mask)},
        {'OutTrue': 'ot', 'OutFalse': 'of'}, {'level': 0})
    cases['merge_lod_tensor'] = (
        'merge_lod_tensor', {'X': ('x', rows), 'Mask': ('m', mask),
                             'InTrue': ('it', _f32(rng, 5, 3)),
                             'InFalse': ('if', _f32(rng, 5, 3))},
        {'Out': 'out'}, {'level': 0})
    cases['lod_rank_table'] = ('lod_rank_table', {'X': ('x', rows)},
                               {'Out': 'out'}, {'level': 0})
    cases['reorder_lod_tensor_by_rank'] = (
        'reorder_lod_tensor_by_rank',
        {'X': ('x', rows), 'RankTable': ('t', np.array([3, 0, 4, 1, 2],
                                                       'int32'))},
        {'Out': 'out'}, {})
    return cases


ONE_OP = _one_op_cases()
# (output slot, inputs differentiated) of the cases with a generic grad
GRADS = {'where_select_True': ('Out', ('x', 'y')),
         'where_select_False': ('Out', ('x', 'y')),
         'split_lod_tensor': ('OutTrue', ('x', )),
         'merge_lod_tensor': ('Out', ('it', 'if')),
         'reorder_lod_tensor_by_rank': ('Out', ('x', )),
         'increment_f32': ('Out', ('x', ))}


@pytest.mark.parametrize('name', sorted(ONE_OP))
def test_one_op_matches_jax(name):
    case = ONE_OP[name]
    want = _forward(jfluid, case)
    got = _forward(tfluid, case)
    for slot, g, w in zip(case[2], got, want):
        _same(g, w, '%s %s' % (name, slot))
    if name in GRADS:
        slot, wrt = GRADS[name]
        shape = want[list(case[2]).index(slot)].shape
        cot = np.random.RandomState(8).standard_normal(shape).astype(
            'float32')
        wants = _grads(jfluid, case, slot, wrt, cot)
        assert max(np.abs(w).max() for w in wants) > 0, name
        for n, g, w in zip(wrt, _grads(tfluid, case, slot, wrt, cot), wants):
            _same(g, w, '%s %s@GRAD' % (name, n))


def test_is_empty_of_an_empty_tensor():
    case = ('is_empty', {'X': ('x', np.zeros((0, 3), 'float32'))},
            {'Out': 'out'}, {})
    got, = _forward(tfluid, case)
    want, = _forward(jfluid, case)
    assert bool(got[0]) and bool(want[0])


def test_rank_table_orders_lod_rows_like_jax():
    lengths = [2, 5, 3, 5, 1]

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data('x', shape=[3], lod_level=1)
            table = fluid.layers.lod_rank_table(x)
            out = fluid.layers.reorder_lod_tensor_by_rank(x, table)
            n = fluid.layers.array_length(fluid.layers.array_write(
                fluid.layers.sequence_pool(x, 'sum'),
                fluid.layers.fill_constant([1], 'int64', 2)))
        return dict(main=main, startup=startup,
                    fetch=[table.name, out.name, n.name])

    flat = np.random.RandomState(1).standard_normal(
        (sum(lengths), 3)).astype('float32')
    jm, tm = _build(build)
    outs = []
    for fluid, m in ((jfluid, jm), (tfluid, tm)):
        lt = fluid.core.LoDTensor(flat)
        lt.set_recursive_sequence_lengths([lengths])
        outs.append(_run(fluid, m, {'x': lt})[0][0])
    (wt, wo, wn), (gt, go, gn) = outs
    _same(gt, wt, 'rank table')
    np.testing.assert_array_equal(np.asarray(gt), [1, 3, 2, 0, 4])
    _same(go, wo, 'reordered rows')
    _same(gn, wn, 'array length')
    assert int(np.asarray(gn)[0]) == 3


# ---- While and tensor arrays (tests/test_control_flow.py's cases) ----

def _counting_loop(limit):
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            i = fluid.layers.fill_constant(shape=[1], dtype='float32',
                                           value=0.0)
            lim = fluid.layers.fill_constant(shape=[1], dtype='float32',
                                             value=limit)
            total = fluid.layers.fill_constant(shape=[1], dtype='float32',
                                               value=0.0)
            cond = fluid.layers.less_than(x=i, y=lim)
            w = fluid.layers.While(cond=cond)
            with w.block():
                fluid.layers.assign(fluid.layers.elementwise_add(total, i),
                                    total)
                fluid.layers.increment(x=i, value=1.0, in_place=True)
                fluid.layers.less_than(x=i, y=lim, cond=cond)
        return dict(main=main, startup=startup, fetch=[total.name, i.name])
    return build


@pytest.mark.parametrize('limit,total', [(5.0, 10.0), (7.0, 21.0),
                                         (0.0, 0.0)])
def test_while_unbounded_counts_like_jax(limit, total):
    (got, ), block = _both(_counting_loop(limit))
    assert float(got[0][0]) == total and float(got[1][0]) == limit
    assert 'while' in block.refusal and 'host' in block.refusal


def _bounded_grad_program(max_trip, stop_d1=False):
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ds = [fluid.layers.data(name='d%d' % k, shape=[10],
                                    dtype='float32', append_batch_size=False)
                  for k in range(3)]
            for k, v in enumerate(ds):
                v.stop_gradient = stop_d1 and k == 1
            i = fluid.layers.fill_constant(shape=[1], dtype='int64', value=0)
            data_array = fluid.layers.array_write(x=ds[0], i=i)
            i = fluid.layers.increment(x=i)
            fluid.layers.array_write(x=ds[1], i=i, array=data_array)
            i = fluid.layers.increment(x=i)
            fluid.layers.array_write(x=ds[2], i=i, array=data_array)
            i = fluid.layers.fill_constant(shape=[1], dtype='int64', value=0)
            init = fluid.layers.fill_constant(shape=[10], dtype='float32',
                                              value=0.0)
            mem_array = fluid.layers.array_write(x=init, i=i)
            array_len = fluid.layers.fill_constant(shape=[1], dtype='int64',
                                                   value=3)
            cond = fluid.layers.less_than(x=i, y=array_len)
            w = fluid.layers.While(cond=cond, max_trip_count=max_trip)
            with w.block():
                d = fluid.layers.array_read(array=data_array, i=i)
                prev = fluid.layers.array_read(array=mem_array, i=i)
                result = fluid.layers.elementwise_add(x=d, y=prev)
                fluid.layers.increment(x=i, value=1.0, in_place=True)
                fluid.layers.array_write(result, i=i, array=mem_array)
                fluid.layers.less_than(x=i, y=array_len, cond=cond)
            sum_result = fluid.layers.array_read(array=mem_array, i=i)
            loss = fluid.layers.mean(sum_result)
            fluid.backward.append_backward(loss)
        return dict(main=main, startup=startup,
                    fetch=[sum_result.name, loss.name, mem_array.name,
                           'd0@GRAD', 'd2@GRAD'] +
                    ([] if stop_d1 else ['d1@GRAD']))
    return build


@pytest.mark.parametrize('max_trip', [3, 8])
def test_while_bounded_grad_like_jax(max_trip):
    """tests/test_control_flow.py::test_while_grad_bounded: three slices
    summed through a tensor array in a bounded loop; each slice's
    gradient is 1/10.  With a bound past the exit, the trips after it
    change nothing."""
    rng = np.random.RandomState(0)
    feed = {k: rng.rand(10).astype('float32') for k in ('d0', 'd1', 'd2')}
    (got, ), block = _both(_bounded_grad_program(max_trip), feed)
    np.testing.assert_allclose(got[0], feed['d0'] + feed['d1'] + feed['d2'],
                               rtol=TOL)
    assert isinstance(got[2], tfluid.core.LoDTensorArray)
    assert len(got[2]) == 1 + max_trip  # preallocated to len + bound
    for g in got[3:]:
        np.testing.assert_allclose(g, np.full(10, 0.1), rtol=TOL)
    assert block.refusal is None  # capturable


def test_while_bounded_grad_with_stop_gradient_slice():
    """A slice with stop_gradient gets no grad; the other slices' grads
    still reach their slots."""
    rng = np.random.RandomState(1)
    feed = {k: rng.rand(10).astype('float32') for k in ('d0', 'd1', 'd2')}
    (got, ), _ = _both(_bounded_grad_program(3, stop_d1=True), feed)
    for g in got[3:]:
        np.testing.assert_allclose(g, np.full(10, 0.1), rtol=TOL)


def test_array_reads_route_grads_by_index():
    """tests/test_control_flow.py::test_while_grad_with_stop_gradient_slice:
    two reads of one array at known indices, each slice's gradient
    routed to its write."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ds = [fluid.layers.data(name='d%d' % k, shape=[10],
                                    dtype='float32', append_batch_size=False)
                  for k in range(3)]
            ds[0].stop_gradient = ds[2].stop_gradient = False
            i = fluid.layers.fill_constant(shape=[1], dtype='int64', value=0)
            arr = fluid.layers.array_write(x=ds[0], i=i)
            i = fluid.layers.increment(x=i)
            fluid.layers.array_write(x=ds[1], i=i, array=arr)
            i = fluid.layers.increment(x=i)
            fluid.layers.array_write(x=ds[2], i=i, array=arr)
            i0 = fluid.layers.fill_constant(shape=[1], dtype='int64', value=0)
            i2 = fluid.layers.fill_constant(shape=[1], dtype='int64', value=2)
            a = fluid.layers.array_read(array=arr, i=i0)
            b = fluid.layers.array_read(array=arr, i=i2)
            loss = fluid.layers.elementwise_add(
                fluid.layers.mean(a),
                fluid.layers.scale(fluid.layers.mean(b), scale=3.0))
            fluid.backward.append_backward(loss)
        return dict(main=main, startup=startup,
                    fetch=['d0@GRAD', 'd2@GRAD', arr.name])

    rng = np.random.RandomState(1)
    feed = {k: rng.rand(10).astype('float32') for k in ('d0', 'd1', 'd2')}
    (got, ), _ = _both(build, feed)
    np.testing.assert_allclose(got[0], np.full(10, 0.1), rtol=TOL)
    np.testing.assert_allclose(got[1], np.full(10, 0.3), rtol=TOL)
    assert isinstance(got[2], tfluid.core.LoDTensorArray)
    np.testing.assert_array_equal(
        np.asarray(got[2]), np.stack([feed['d0'], feed['d1'], feed['d2']]))


def test_unbounded_loop_grows_an_array_like_the_bounded_one():
    """The port's unbounded loop keeps its counter's host value from trip
    to trip, so an array written at the counter grows as a list (the JAX
    package's while_loop cannot carry a growing list): its sums equal the
    bounded loop's."""
    rng = np.random.RandomState(2)
    feed = {k: rng.rand(10).astype('float32') for k in ('d0', 'd1', 'd2')}

    def loop(max_trip):
        with tfluid.unique_name.guard():
            m = _bounded_grad_program(max_trip)(tfluid)
        main = m['main']
        # the forward half: up to the loss
        n_fwd = [op.type for op in main.global_block().ops].index('mean') + 1
        del main.global_block().ops[n_fwd:]
        m['fetch'] = m['fetch'][:3]
        return _run(tfluid, m, feed)

    (bounded, ), _ = loop(5)
    (unbounded, ), block = loop(0)
    assert 'while' in block.refusal
    np.testing.assert_allclose(unbounded[0], bounded[0], rtol=TOL)
    assert len(unbounded[2]) == 4  # written at 0..3, no padding
    np.testing.assert_array_equal(np.asarray(unbounded[2]),
                                  np.asarray(bounded[2])[:4])


def test_bounded_loop_refuses_a_carry_that_changes_shape():
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            i = fluid.layers.fill_constant([1], 'float32', 0.0)
            lim = fluid.layers.fill_constant([1], 'float32', 2.0)
            acc = fluid.layers.fill_constant([2], 'float32', 1.0)
            cond = fluid.layers.less_than(x=i, y=lim)
            w = fluid.layers.While(cond=cond, max_trip_count=2)
            with w.block():
                fluid.layers.assign(fluid.layers.concat([acc, acc]), acc)
                fluid.layers.increment(x=i, in_place=True)
                fluid.layers.less_than(x=i, y=lim, cond=cond)
        return dict(main=main, startup=startup, fetch=[acc.name])

    jm, tm = _build(build)
    for fluid, m in ((jfluid, jm), (tfluid, tm)):
        with pytest.raises(Exception, match='changed shape'):
            _run(fluid, m, {})


# ---- conditional_block (tests/test_conditional_block.py's cases) ----

def _cond_block(fluid, main, cond_var, body, out_names):
    sub = main.create_block()
    body()
    main.rollback()
    main.current_block().append_op(
        type='conditional_block', inputs={'Cond': [cond_var]},
        outputs={'Out': out_names}, attrs={'sub_block': sub})


def _cb_program(kind, cond_value):
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            cond = fluid.layers.fill_constant([1], 'bool', bool(cond_value))
            blk = main.current_block()
            const = lambda v: fluid.layers.fill_constant([1], 'float32', v)
            fetch = None
            if kind == 'keeps_old':
                v = const(3.0)
                _cond_block(fluid, main, cond,
                            lambda: fluid.layers.assign(const(7.0), v),
                            [v.name])
                fetch = fluid.layers.scale(v, scale=1.0).name
            elif kind in ('read_rejected', 'fetch_rejected'):
                fresh = blk.create_var(name='fresh_' + kind,
                                       dtype='float32', shape=[1])
                _cond_block(fluid, main, cond,
                            lambda: fluid.layers.assign(const(7.0), fresh),
                            [fresh.name])
                fetch = fresh.name if kind == 'fetch_rejected' else \
                    fluid.layers.scale(fresh, scale=2.0).name
            elif kind == 'guarded_read':
                v = const(0.0)
                fresh = blk.create_var(name='guarded_x', dtype='float32',
                                       shape=[1])
                _cond_block(fluid, main, cond,
                            lambda: fluid.layers.assign(const(7.0), fresh),
                            [fresh.name])
                _cond_block(fluid, main, cond, lambda: fluid.layers.assign(
                    fluid.layers.scale(fresh, scale=2.0), v), [v.name])
                fetch = fluid.layers.scale(v, scale=1.0).name
            elif kind == 'loop_write':
                fresh = blk.create_var(name='loop_x', dtype='float32',
                                       shape=[1])
                _cond_block(fluid, main, cond,
                            lambda: fluid.layers.assign(const(7.0), fresh),
                            [fresh.name])
                i, limit = const(0.0), const(0.0)
                wcond = fluid.layers.less_than(x=i, y=limit)
                w = fluid.layers.While(cond=wcond)
                with w.block():
                    fluid.layers.assign(const(8.0), fresh)
                    fluid.layers.increment(x=i, value=1.0, in_place=True)
                    fluid.layers.less_than(x=i, y=limit, cond=wcond)
                fetch = fluid.layers.scale(fresh, scale=1.0).name
            elif kind == 'both_branches':
                notc = fluid.layers.logical_not(cond)
                fresh = blk.create_var(name='branch_out', dtype='float32',
                                       shape=[1])
                _cond_block(fluid, main, cond,
                            lambda: fluid.layers.assign(const(7.0), fresh),
                            [fresh.name])
                _cond_block(fluid, main, notc,
                            lambda: fluid.layers.assign(const(9.0), fresh),
                            [fresh.name])
                fetch = fluid.layers.scale(fresh, scale=1.0).name
            elif kind == 'persisting_rejected':
                fresh = blk.create_var(name='persist_me', dtype='float32',
                                       shape=[1])
                fresh.persistable = True
                _cond_block(fluid, main, cond,
                            lambda: fluid.layers.assign(const(7.0), fresh),
                            [fresh.name])
                fetch = const(1.0).name
            elif kind == 'startup_persistable':
                v = fluid.layers.create_global_var(
                    shape=[1], value=3.0, dtype='float32', persistable=True,
                    name='ctr_%d' % cond_value)
                _cond_block(fluid, main, cond,
                            lambda: fluid.layers.assign(const(7.0), v),
                            [v.name])
                fetch = fluid.layers.scale(v, scale=1.0).name
        return dict(main=main, startup=startup, fetch=[fetch])
    return build


CB_VALUES = [('keeps_old', 1, 7.0), ('keeps_old', 0, 3.0),
             ('guarded_read', 1, 14.0), ('guarded_read', 0, 0.0),
             ('both_branches', 1, 7.0), ('both_branches', 0, 9.0),
             ('startup_persistable', 1, 7.0),
             ('startup_persistable', 0, 3.0)]
CB_ERRORS = [('read_rejected', 'conditional_block'),
             ('fetch_rejected', 'conditional_block'),
             ('loop_write', 'conditional_block'),
             ('persisting_rejected', 'not initialized')]


@pytest.mark.parametrize('kind,cond_value,want', CB_VALUES)
def test_conditional_block_blends_like_jax(kind, cond_value, want):
    (got, ), _ = _both(_cb_program(kind, cond_value))
    assert float(got[0][0]) == want


@pytest.mark.parametrize('kind,match', CB_ERRORS)
def test_conditional_block_rejects_like_jax(kind, match):
    jm, tm = _build(_cb_program(kind, 1))
    for fluid, m in ((jfluid, jm), (tfluid, tm)):
        with pytest.raises(Exception, match=match):
            _run(fluid, m, {})


# ---- split / merge and IfElse (tests/test_split_merge_lod.py's cases) ----

B, D = 6, 4


def _split_feed(seed):
    rng = np.random.RandomState(seed)
    return {'x': rng.standard_normal((B, D)).astype('float32'),
            'm': rng.rand(B, 1) > 0.5}


def _split_program(kind):
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data('x', shape=[D])
            x.stop_gradient = False
            m = fluid.layers.data('m', shape=[1], dtype='bool')
            out_t, out_f = fluid.layers.split_lod_tensor(x, m)
            if kind == 'split':
                fetch = [out_t.name, out_f.name]
            elif kind == 'merge':
                fetch = [fluid.layers.merge_lod_tensor(out_t, out_f, x,
                                                       m).name]
            else:
                merged = fluid.layers.merge_lod_tensor(
                    fluid.layers.scale(out_t, scale=3.0),
                    fluid.layers.scale(out_f, scale=7.0), x, m)
                loss = fluid.layers.reduce_sum(merged)
                fetch = [fluid.backward.calc_gradient(loss, [x])[0].name]
        return dict(main=main, startup=startup, fetch=fetch)
    return build


@pytest.mark.parametrize('kind,seed', [('split', 0), ('merge', 1),
                                       ('grad', 2)])
def test_split_merge_like_jax(kind, seed):
    feed = _split_feed(seed)
    (got, ), _ = _both(_split_program(kind), feed)
    sel = feed['m'][:, 0]
    if kind == 'split':
        np.testing.assert_array_equal(got[0][:sel.sum()], feed['x'][sel])
        np.testing.assert_array_equal(got[1][:(~sel).sum()],
                                      feed['x'][~sel])
    elif kind == 'merge':
        np.testing.assert_array_equal(got[0], feed['x'])
    else:
        np.testing.assert_allclose(
            got[0], np.where(feed['m'], 3.0, 7.0) * np.ones((B, D)),
            rtol=TOL)


def _ifelse_program(routing, train=False):
    """IfElse over y < 0: the true branch x @ W_true, the false branch
    x @ W_false; ``routing``: 'routed' (both branches read their rows
    through ie.input), 'unrouted' (both read x) or 'mixed' (the true
    branch routed, the false branch 7 x unrouted)."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data('x', shape=[D])
            lbl = fluid.layers.data('y', shape=[1])
            limit = fluid.layers.fill_constant(shape=[1], dtype='float32',
                                               value=0.0)
            cond = fluid.layers.less_than(x=lbl, y=limit)
            ie = fluid.layers.IfElse(cond)

            def branch(name, value, routed):
                xin = ie.input(x) if routed else x
                if routing == 'mixed' and name == 'w_false':
                    return fluid.layers.scale(x, scale=7.0)
                return fluid.layers.fc(
                    xin, size=D, bias_attr=False, param_attr=fluid.ParamAttr(
                        name=name,
                        initializer=fluid.initializer.Constant(value)))

            with ie.true_block():
                ie.output(branch('w_true', 0.5, routing != 'unrouted'))
            with ie.false_block():
                ie.output(branch('w_false', -0.25, routing == 'routed'))
            out = ie()[0]
            loss = fluid.layers.mean(out)
            fetch = [out.name, loss.name]
            if train:
                fluid.optimizer.SGD(0.05).minimize(loss)
                fetch += ['w_true', 'w_false', 'w_true@GRAD',
                          'w_false@GRAD']
        return dict(main=main, startup=startup, fetch=fetch)
    return build


@pytest.mark.parametrize('routing', ['routed', 'unrouted', 'mixed'])
def test_ifelse_like_jax(routing):
    rng = np.random.RandomState(3)
    feed = {'x': rng.standard_normal((B, D)).astype('float32'),
            'y': rng.standard_normal((B, 1)).astype('float32')}
    (got, ), _ = _both(_ifelse_program(routing), feed)
    x, y = feed['x'], feed['y']
    if routing == 'mixed':
        want = np.where(y < 0, x @ np.full((D, D), 0.5), 7.0 * x)
    else:
        want = np.where(y < 0, x @ np.full((D, D), 0.5),
                        x @ np.full((D, D), -0.25))
    np.testing.assert_allclose(got[0], want, rtol=TOL, atol=1e-6)


def test_ifelse_routed_trains_like_jax():
    """Three SGD steps on new batches: the loss, both branch weights and
    their gradients in parity at every step, and both weights moved."""
    rng = np.random.RandomState(4)
    jm, tm = _build(_ifelse_program('routed', train=True))
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(jm['startup'], scope=jscope)
    texe.run(tm['startup'], scope=tscope)
    for step in range(3):
        feed = {'x': rng.standard_normal((B, D)).astype('float32'),
                'y': rng.standard_normal((B, 1)).astype('float32')}
        want = jexe.run(jm['main'], feed=feed, fetch_list=jm['fetch'],
                        scope=jscope)
        got = texe.run(tm['main'], feed=feed, fetch_list=tm['fetch'],
                       scope=tscope)
        for name, g, w in zip(tm['fetch'], got, want):
            _same(g, w, 'step %d: %s' % (step, name))
    assert not np.allclose(got[2], 0.5) and not np.allclose(got[3], -0.25)


# ---- Switch, Print ----

def _switch_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        step = fluid.layers.cast(fluid.layers.autoincreased_step_counter(
            counter_name='@SWITCH_STEP@', begin=0), 'float32')
        lr = fluid.layers.create_global_var(shape=[1], value=0.0,
                                            dtype='float32',
                                            persistable=True, name='sw_lr')
        b1 = fluid.layers.fill_constant([1], 'float32', 2.0)
        b2 = fluid.layers.fill_constant([1], 'float32', 4.0)
        sw = fluid.layers.Switch()
        with sw.block():
            with sw.case(fluid.layers.less_than(step, b1)):
                fluid.layers.assign(
                    fluid.layers.fill_constant([1], 'float32', 1.0), lr)
            with sw.case(fluid.layers.less_than(step, b2)):
                fluid.layers.assign(
                    fluid.layers.fill_constant([1], 'float32', 0.5), lr)
            with sw.default():
                fluid.layers.assign(
                    fluid.layers.fill_constant([1], 'float32', 0.1), lr)
    return dict(main=main, startup=startup, fetch=[lr.name, step.name])


def test_switch_over_a_step_counter_like_jax():
    runs, block = _both(_switch_program, runs=6)
    np.testing.assert_allclose([r[0][0] for r in runs],
                               [1.0, 1.0, 0.5, 0.5, 0.1, 0.1], rtol=TOL)
    assert [float(r[1][0]) for r in runs] == [0, 1, 2, 3, 4, 5]
    assert block.refusal is None


def _print_in_branch(where):
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data('x', shape=[D])
            cond = fluid.layers.fill_constant([1], 'bool', True)
            if where == 'ifelse':
                ie = fluid.layers.IfElse(cond)
                with ie.true_block():
                    ie.output(fluid.layers.Print(x))
                with ie.false_block():
                    ie.output(fluid.layers.scale(x, scale=2.0))
                out = ie()[0]
            elif where == 'switch':
                out = fluid.layers.create_global_var(
                    shape=[1], value=0.0, dtype='float32', persistable=True,
                    name='printed')
                sw = fluid.layers.Switch()
                with sw.block():
                    with sw.case(cond):
                        fluid.layers.assign(fluid.layers.Print(
                            fluid.layers.fill_constant([1], 'float32', 1.0)),
                            out)
            else:
                out = fluid.layers.scale(x, scale=1.0)
                _cond_block(fluid, main, cond,
                            lambda: fluid.layers.assign(
                                fluid.layers.Print(x), out), [out.name])
        return dict(main=main, startup=startup, fetch=[out.name])
    return build


@pytest.mark.parametrize('where', ['ifelse', 'switch', 'conditional_block'])
def test_host_op_in_a_branch_is_refused_like_jax(where):
    jm, tm = _build(_print_in_branch(where))
    feed = {'x': np.ones((2, D), 'float32')}
    for fluid, m in ((jfluid, jm), (tfluid, tm)):
        with pytest.raises(RuntimeError, match='host op'):
            _run(fluid, m, feed)


def test_print_runs_eagerly_and_passes_its_input_through(capsys):
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data('x', shape=[D])
            out = fluid.layers.scale(fluid.layers.Print(x, message='x is'),
                                     scale=2.0)
        return dict(main=main, startup=startup, fetch=[out.name])

    feed = {'x': np.arange(2 * D, dtype='float32').reshape(2, D)}
    (got, ), block = _both(build, feed)
    np.testing.assert_array_equal(got[0], 2 * feed['x'])
    assert 'x is' in capsys.readouterr().out
    assert 'print' in block.refusal


def test_the_control_flow_lowerings_are_registered():
    """Every lowering of the JAX package's control_flow_ops module, the
    compare and logical family, increment, where_select and the rank-table
    ops; the unbounded while declared uncapturable, the bounded one not."""
    from paddle_tpu.ops import control_flow_ops as jcf
    from paddle_tpu.ops import registry as jregistry
    from paddle_tpu_torch.ops import registry as tregistry
    ported = {name for name, fn in jregistry._LOWERINGS.items()
              if fn.__module__ == jcf.__name__}
    assert len(ported) == 11  # recurrent and the ten of this slice
    ported |= set(ONE_OP_TYPES)
    missing = sorted(n for n in ported if n not in tregistry._LOWERINGS)
    assert not missing, missing
    while_op = tfluid.Program().global_block().append_op(
        type='while', attrs={'max_trip_count': 0})
    assert 'while' in tregistry.capture_refusal(while_op)
    while_op.attrs['max_trip_count'] = 4
    assert tregistry.capture_refusal(while_op) is None


ONE_OP_TYPES = sorted({case[0] for case in ONE_OP.values()})


# ---- path G's control-flow programs (chip_smoke.py), at width 8 ----

def hand_over(tm, jscope, tscope):
    """Every persistable var of the port's main program from the JAX
    scope, in the port's declared dtypes (the JAX package holds int64 as
    int32).  Returns the arrays handed over."""
    main = tm['main']
    state = {v.name: np.asarray(jscope.find_var(v.name).value()).astype(
        v.np_dtype) for v in main.list_vars() if v.persistable}
    tfluid.persistables_from_numpy(main, state, scope=tscope,
                                   place=tfluid.CPUPlace())
    return state


def _train_both(build, feed, fetch_of, steps=3):
    """``steps`` steps of ``build``'s main program in each package from the
    JAX startup's state (int64 counters handed over by value): each
    step's fetches (``fetch_of(model)``) held against the JAX package's.
    Returns the port's."""
    jm, tm = _build(build)
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(jm['startup'], scope=jscope)
    hand_over(tm, jscope, tscope)
    outs = []
    for step in range(steps):
        want = jexe.run(jm['main'], feed=feed, fetch_list=fetch_of(jm),
                        scope=jscope)
        got = texe.run(tm['main'], feed=feed, fetch_list=fetch_of(tm),
                       scope=tscope)
        for name, g, w in zip(fetch_of(tm), got, want):
            _same(g, w, 'step %d: %s' % (step, name))
        outs.append(got)
    return outs


@pytest.mark.parametrize('which', ['while', 'ifelse', 'switch'])
def test_path_g_control_programs_train_like_jax(which):
    """chip_smoke's G4 programs at width 8, batch 6: the bounded While
    (16 trips through an fc, a tensor array), IfElse routing rows to two
    fc branches, and a Switch over a step counter setting SGD's rate;
    three SGD steps in parity, the parameters after each."""
    rng = np.random.RandomState(9)
    f32 = lambda *s: rng.standard_normal(s).astype('float32')
    build = {'while': chip_smoke.flow_loop_programs,
             'ifelse': chip_smoke.flow_ifelse_programs,
             'switch': chip_smoke.flow_switch_programs}[which]
    feed = {'x': f32(6, 8), 'y': f32(6, 8) if which == 'while' else
            f32(6, 1), 't': f32(6, 8)}
    if which == 'switch':
        del feed['y']
    elif which == 'while':
        del feed['t']

    def fetch_of(m):
        return [m['loss'].name] + sorted(
            p.name for p in m['main'].all_parameters()) + (
            [m['lr'].name] if which == 'switch' else [])

    outs = _train_both(lambda fluid: build(fluid, width=8), feed, fetch_of,
                       steps=5 if which == 'switch' else 3)
    assert outs[-1][0][0] < outs[0][0][0]  # the loss falls
    if which == 'switch':
        np.testing.assert_allclose(
            [o[-1][0] for o in outs],
            [chip_smoke._switch_rate(s) for s in range(5)], rtol=TOL)


def test_path_g_loop_request_unbounded_matches_bounded():
    """The G4 loop served unbounded (a growing list, eager) and bounded
    (a preallocated stack): the same last state and array rows."""
    rng = np.random.RandomState(10)
    feed = {'x': rng.standard_normal((6, 8)).astype('float32'),
            'y': rng.standard_normal((6, 8)).astype('float32')}
    outs = []
    for trips in (chip_smoke.FLOW_TRIPS, 0):
        with tfluid.unique_name.guard():
            m = chip_smoke.flow_loop_programs(tfluid, max_trip_count=trips,
                                              width=8)
        m['startup'].random_seed = 1
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(m['startup'], scope=scope)
        outs.append(exe.run(m['test'], feed=feed, fetch_list=[
            m['last'].name, m['states'].name], scope=scope))
    (b_last, b_arr), (u_last, u_arr) = outs
    assert len(b_arr) == len(u_arr) == 1 + chip_smoke.FLOW_TRIPS
    np.testing.assert_array_equal(u_last, b_last)
    np.testing.assert_array_equal(np.asarray(u_arr), np.asarray(b_arr))


def test_cost_report_counts_the_loop_body_every_trip():
    """``cost_report``'s FLOPs of the bounded loop's request count its fc
    (2 B D^2 a trip) at every one of the 16 trips, and the unbounded
    loop's the same."""
    b, d = 6, 8
    feed = {'x': np.ones((b, d), 'float32'), 'y': np.ones((b, d), 'float32')}
    flops = []
    for trips in (chip_smoke.FLOW_TRIPS, 0):
        with tfluid.unique_name.guard():
            m = chip_smoke.flow_loop_programs(tfluid, max_trip_count=trips,
                                              width=d)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(m['startup'], scope=scope)
        tfluid.FLAGS.cost_accounting = True
        try:
            exe.run(m['test'], feed=feed, fetch_list=[m['last'].name],
                    scope=scope)
        finally:
            tfluid.FLAGS.cost_accounting = False
        flops.append(exe.cost_report()[-1]['flops_per_step'])
    products = chip_smoke.FLOW_TRIPS * 2 * b * d * d
    assert flops[0] >= products and flops[1] >= products, flops
