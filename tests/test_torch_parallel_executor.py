"""The port's data-parallel training (``fluid.ParallelExecutor`` on
``torch.distributed``, ``parallel``, ``DistributeTranspiler``) against the
JAX package's ``ParallelExecutor``.

- The pure functions (``pad_ragged_batch`` with every keyword,
  ``normalize_ragged_feed_list``, ``parse_distributed_env``, the
  transpiler's annotations and stubs, ``HashName`` and ``RoundRobin``)
  equal the JAX package's on the same inputs.
- World size 1, in this process, ``use_cuda=False``: the counterparts of
  ``tests/test_parallel_executor.py``'s convergence and single-device cases
  and of ``tests/test_parallel_run_multi.py``'s, each against the JAX
  package's ``ParallelExecutor`` on its default 8-device mesh (losses at
  that file's rtol 2e-4 / atol 1e-5; the counts equal).
- Two gloo ranks, each a subprocess running this file's ``_worker`` (which
  imports the port alone), against the JAX ``ParallelExecutor`` on a mesh
  of 2 of the 8 virtual devices: the JAX side's startup state and seeded
  global batches go to the workers as ``.npz`` files, and their fetches and
  final state come back.  Rank 1 starts from other values and takes rank
  0's by ``bcast_params()``; both ranks end bitwise equal.  Tolerances, as
  each model's own test file states them: the MLP (``test_torch_mnist.py``)
  and the Transformer (``test_torch_training.py``) losses at rtol 1e-5 and
  every persistable at rtol / atol 1e-4; the batch-norm net
  (``test_torch_resnet.py``'s cifar-20 bounds) loss 1e-5, running
  statistics |d| / |v| 1e-4, parameters |d| / |v| 3e-2.
  A global batch of 2, one row a rank, is held at the MLP's tolerances.
- Every case this slice leaves out raises ``NotImplementedError``, and so
  does, on both ranks, an op over the split rows that is neither dp-aware
  nor row-wise for its attrs (``reduce_max`` and ``cumsum`` over dim 0, a
  ``transpose`` of the rows, ``squared_l2_norm`` at one row a rank).
"""

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu_torch.fluid as tfluid  # noqa: E402
from paddle_tpu_torch import parallel as tparallel  # noqa: E402
from paddle_tpu_torch.models import transformer as torch_transformer  # noqa
from paddle_tpu_torch.fluid import parallel_executor as tpe  # noqa: E402

if __name__ != '__main__':
    # the gloo workers (this file run as a script) import the port alone
    import jax
    import paddle_tpu.fluid as jfluid
    from paddle_tpu import parallel as jparallel
    from paddle_tpu.fluid import parallel_executor as jpe
    from paddle_tpu.models import transformer as jax_transformer
    from paddle_tpu.ops import registry as jregistry

RTOL, ATOL = 2e-4, 1e-5          # tests/test_parallel_run_multi.py's
STATE_TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(src_vocab=100, trg_vocab=100, max_len=16, n_layer=2, n_head=4,
             d_model=64, d_ff=128)
WORKER_TIMEOUT = 240


# ---------------------------------------------------------------------------
# models, built the same in both packages
# ---------------------------------------------------------------------------
def mlp(fluid, seed=5, opt='sgd', lr=0.5, clip=None, extra=None):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name='img', shape=[64], dtype='float32')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        hidden = fluid.layers.fc(input=img, size=128, act='relu')
        pred = fluid.layers.fc(input=hidden, size=10, act='softmax')
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        if extra == 'reduce_max':
            loss = fluid.layers.elementwise_add(
                loss, fluid.layers.reduce_max(
                    fluid.layers.reduce_sum(hidden, dim=1), dim=0))
        elif extra == 'transpose':
            flipped = fluid.layers.transpose(hidden, [1, 0])
            loss = fluid.layers.elementwise_add(
                loss, fluid.layers.mean(flipped))
        elif extra == 'cumsum':
            loss = fluid.layers.elementwise_add(loss, fluid.layers.mean(
                fluid.layers.cumsum(hidden, axis=0)))
        elif extra == 'squared_l2_norm':
            # a reduction over every element with no layer of its own: at
            # one row a rank its [1] output has the rows' shape
            helper = fluid.layer_helper.LayerHelper('squared_l2_norm')
            norm = helper.create_variable_for_type_inference('float32')
            helper.append_op(type='squared_l2_norm',
                             inputs={'X': [hidden]}, outputs={'Out': [norm]})
            loss = fluid.layers.elementwise_add(loss,
                                                fluid.layers.mean(norm))
        if clip is not None:
            fluid.clip.set_gradient_clip(
                fluid.clip.GradientClipByGlobalNorm(clip_norm=clip),
                program=main)
        make = {'sgd': lambda: fluid.optimizer.SGD(learning_rate=lr),
                'adam': lambda: fluid.optimizer.Adam(learning_rate=lr)}
        make[opt]().minimize(loss)
    return dict(main=main, startup=startup, loss=loss.name, pred=pred.name)


def bn_net(fluid, seed=3):
    """conv2d -> batch_norm (training) -> relu -> pool -> fc, Momentum."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name='img', shape=[3, 8, 8],
                                dtype='float32')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        conv = fluid.layers.conv2d(img, num_filters=8, filter_size=3,
                                   padding=1, bias_attr=False)
        bn = fluid.layers.batch_norm(conv, act='relu')
        pool = fluid.layers.pool2d(bn, pool_size=2, pool_stride=2)
        pred = fluid.layers.fc(input=pool, size=10, act='softmax')
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
    return dict(main=main, startup=startup, loss=loss.name, pred=pred.name)


def transformer(fluid):
    module = torch_transformer if fluid is tfluid else jax_transformer
    with fluid.unique_name.guard():
        m = module.build(**SMALL)
    return dict(main=m['main'], startup=m['startup'], loss=m['loss'].name,
                pred=m['prediction'].name)


MODELS = {'mlp': mlp, 'bn': bn_net, 'transformer': transformer}


def mlp_batch(rng, n):
    w = np.random.RandomState(7).standard_normal((64, 10)).astype('float32')
    x = rng.standard_normal((n, 64)).astype('float32')
    y = np.argmax(x @ w, axis=1).astype('int64')[:, None]
    return {'img': x, 'label': y}


def image_batch(rng, n):
    return {'img': rng.standard_normal((n, 3, 8, 8)).astype('float32'),
            'label': rng.randint(0, 10, (n, 1)).astype('int64')}


def token_batch(rng, n):
    return {k: rng.randint(1, SMALL['trg_vocab'], size=(n, 16)).astype(
        'int64') for k in ('src_ids', 'trg_ids', 'lbl_ids')}


# ---------------------------------------------------------------------------
# the two-rank cases: (model, its kwargs, batches, fetch the prediction,
# run the steps as one run_multi)
# ---------------------------------------------------------------------------
def _cases():
    rng = np.random.RandomState(12)
    return {
        'mlp_adam': dict(model='mlp', kw=dict(opt='adam', lr=0.01),
                         feeds=[mlp_batch(rng, 16) for _ in range(5)]),
        'bn': dict(model='bn', kw={},
                   feeds=[image_batch(rng, 8) for _ in range(2)]),
        'transformer': dict(model='transformer', kw={},
                            feeds=[token_batch(rng, 4) for _ in range(2)]),
        # a global batch of 2k + 1 rows, and its per-sample fetch gathered
        'ragged': dict(model='mlp', kw={}, pred=True,
                       feeds=[mlp_batch(rng, 13), mlp_batch(rng, 11)]),
        'clip': dict(model='mlp', kw=dict(clip=0.05),
                     feeds=[mlp_batch(rng, 16) for _ in range(2)]),
        'multi': dict(model='mlp', kw=dict(opt='adam', lr=0.01), multi=True,
                      feeds=[mlp_batch(rng, 16) for _ in range(3)] +
                      [mlp_batch(rng, 9)]),
        'guard_reduce_max': dict(model='mlp', kw=dict(extra='reduce_max'),
                                 feeds=[mlp_batch(rng, 8)]),
        'guard_transpose': dict(model='mlp', kw=dict(extra='transpose'),
                                feeds=[mlp_batch(rng, 8)]),
        'guard_cumsum': dict(model='mlp', kw=dict(extra='cumsum'),
                             feeds=[mlp_batch(rng, 8)]),
        'guard_squared_l2_norm': dict(
            model='mlp', kw=dict(extra='squared_l2_norm'),
            feeds=[mlp_batch(rng, 2)]),
        # one row a rank
        'one_row': dict(model='mlp', kw=dict(opt='adam', lr=0.01),
                        pred=True, feeds=[mlp_batch(rng, 2)
                                          for _ in range(3)]),
    }


def _state_names(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _run_case(fluid, case, exe_of, state):
    """Build the case's model in ``fluid``, load ``state`` (the port) or
    keep the startup's (JAX), and run its steps on ``exe_of(model, scope)``:
    ({step: fetches}, final state)."""
    m = MODELS[case['model']](fluid, **case['kw'])
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        if state is None:
            fluid.Executor(fluid.CPUPlace()).run(m['startup'])
        else:
            fluid.persistables_from_numpy(m['main'], state, scope=scope,
                                          place=fluid.CPUPlace())
        pe = exe_of(m, scope)
        names = [m['loss']] + ([m['pred']] if case.get('pred') else [])
        if case.get('multi'):
            outs = [pe.run_multi(names, feed_list=case['feeds'])]
        else:
            outs = [pe.run(names, feed=f) for f in case['feeds']]
    final = {n: np.asarray(scope.find_var(n).value())
             for n in _state_names(m['main'])}
    return outs, final


# ---------------------------------------------------------------------------
# the gloo worker: this file run as a script, one process a rank
# ---------------------------------------------------------------------------
def _worker(rank, world, workdir, port):
    import datetime
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method='tcp://localhost:%d' % port,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    with open(os.path.join(workdir, 'cases.json')) as f:
        names = json.load(f)
    cases = _cases()
    for name in names:
        case = cases[name]
        with np.load(os.path.join(workdir, name + '.state.npz')) as z:
            state = dict(z)
        if rank:
            # rank 1 starts elsewhere: bcast_params gives it rank 0's
            state = {n: v * 0.5 if v.dtype.kind == 'f' else v
                     for n, v in state.items()}
        out = {}
        try:
            outs, final = _run_case(
                tfluid, case,
                lambda m, scope: tfluid.ParallelExecutor(
                    use_cuda=False, loss_name=m['loss'],
                    main_program=m['main'], scope=scope),
                state)
            for i, fetches in enumerate(outs):
                for j, f in enumerate(fetches):
                    out['fetch_%d_%d' % (i, j)] = np.asarray(f)
            out.update({'state/' + n: v for n, v in final.items()})
        except NotImplementedError as e:
            out['raised'] = np.asarray(str(e))
        np.savez(os.path.join(workdir, '%s.rank%d.npz' % (name, rank)),
                 **out)
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def two_ranks():
    """Every two-rank case run once: the JAX side on 2 devices here, the
    port's in two gloo workers.  {case: (JAX outs, JAX state, [rank 0's,
    rank 1's results])}."""
    cases = _cases()
    mesh = jparallel.make_mesh({'dp': 2}, devices=jax.devices()[:2])
    want = {}
    with tempfile.TemporaryDirectory() as workdir:
        for name, case in cases.items():
            m = MODELS[case['model']](jfluid, **case['kw'])
            scope = jfluid.Scope()
            jfluid.Executor(jfluid.CPUPlace()).run(m['startup'], scope=scope)
            np.savez(os.path.join(workdir, name + '.state.npz'),
                     **{n: np.asarray(scope.find_var(n).value())
                        for n in _state_names(m['main'])})
        with open(os.path.join(workdir, 'cases.json'), 'w') as f:
            json.dump(sorted(cases), f)
        port = _free_port()
        # a rank a core: the two ranks share this host
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), workdir,
             str(port)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        for name, case in cases.items():
            if name.startswith('guard'):
                continue
            want[name] = _run_case(
                jfluid, case,
                lambda m, scope: jfluid.ParallelExecutor(
                    loss_name=m['loss'], main_program=m['main'],
                    scope=scope, mesh=mesh),
                None)
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
            finally:
                p.kill()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        got = {}
        for name in cases:
            got[name] = []
            for r in range(2):
                with np.load(os.path.join(workdir, '%s.rank%d.npz'
                                          % (name, r))) as z:
                    got[name].append(dict(z))
    return {n: (want.get(n, (None, None)) + (got[n], )) for n in cases}


def _outs(res):
    """[step][fetch] of a worker's result."""
    steps = sorted({int(k.split('_')[1]) for k in res
                    if k.startswith('fetch_')})
    return [[res['fetch_%d_%d' % (i, j)] for j in range(
        len([k for k in res if k.startswith('fetch_%d_' % i)]))]
        for i in steps]


def _check_two_ranks(two_ranks, name, loss_rtol=1e-5, state=None):
    want_outs, want_state, (r0, r1) = two_ranks[name]
    assert 'raised' not in r0, str(r0.get('raised'))
    got_outs = _outs(r0)
    assert len(got_outs) == len(want_outs)
    for step, (g, w) in enumerate(zip(got_outs, want_outs)):
        np.testing.assert_allclose(g[0], np.asarray(w[0]), rtol=loss_rtol,
                                   err_msg='loss, step %d' % step)
    for key in [k for k in r0 if k.startswith('state/')]:
        # both ranks hold one replica, bitwise
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
        n = key[len('state/'):]
        if state is None:
            np.testing.assert_allclose(r0[key], want_state[n],
                                       err_msg=n, **STATE_TOL)
        else:
            state(n, r0[key], want_state[n])
    return got_outs, want_outs


def test_two_ranks_mlp_adam_like_jax_on_two_devices(two_ranks):
    _check_two_ranks(two_ranks, 'mlp_adam')


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / max(
        np.linalg.norm(want), 1e-30)


def test_two_ranks_batch_norm_syncs_statistics_like_jax(two_ranks):
    """Synced batch statistics: the loss, every running mean and variance
    and the parameters after two Momentum steps at the cifar-20 bounds."""
    main = bn_net(tfluid)['main']
    stats = {n for op in main.global_block().ops if op.type == 'batch_norm'
             for n in op.input('Mean') + op.input('Variance')}
    assert stats

    def held(n, got, want):
        tol = 1e-4 if n in stats else 3e-2
        assert _rel(got, want) <= tol, (n, _rel(got, want))

    _check_two_ranks(two_ranks, 'bn', state=held)


def test_two_ranks_transformer_like_jax_on_two_devices(two_ranks):
    _check_two_ranks(two_ranks, 'transformer')


def test_two_ranks_ragged_batch_and_gathered_fetch_like_jax(two_ranks):
    """Global batches of 13 and 11 rows (2k + 1 padded to 2k + 2 and
    masked): losses, state, and the per-sample prediction gathered from
    both ranks in order and trimmed to the real rows."""
    got, want = _check_two_ranks(two_ranks, 'ragged')
    for step, (g, w) in enumerate(zip(got, want)):
        assert g[1].shape == np.asarray(w[1]).shape == ((13, 11)[step], 10)
        np.testing.assert_allclose(g[1], np.asarray(w[1]), rtol=RTOL,
                                   atol=ATOL)


def test_two_ranks_global_norm_clip_sees_the_global_gradient(two_ranks):
    _check_two_ranks(two_ranks, 'clip')


def test_two_ranks_run_multi_with_ragged_tail_like_jax(two_ranks):
    _check_two_ranks(two_ranks, 'multi')


def test_two_ranks_one_row_a_rank_like_jax(two_ranks):
    """A global batch of 2: each rank holds one row, every output's dim 0
    is 1, and the means and the gathered prediction are still global."""
    got, want = _check_two_ranks(two_ranks, 'one_row')
    for g, w in zip(got, want):
        assert g[1].shape == np.asarray(w[1]).shape == (2, 10)
        np.testing.assert_allclose(g[1], np.asarray(w[1]), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize('name', ['guard_reduce_max', 'guard_transpose',
                                  'guard_cumsum', 'guard_squared_l2_norm'])
def test_two_ranks_refuse_a_local_reduction_on_both(two_ranks, name):
    """An op over the split rows that is neither dp-aware nor row-wise for
    its attrs raises on both ranks, and neither hangs: the workers went on
    to the next case.  ``reduce_max`` over dim 0 raises in its lowering;
    ``transpose`` moves the rows off dim 0; ``cumsum`` over dim 0 keeps
    the shape but mixes the rows; ``squared_l2_norm`` reduces every row
    to a [1] output, at one row a rank the rows' own shape."""
    r0, r1 = two_ranks[name][2]
    op = name[len('guard_'):]
    for r in (r0, r1):
        assert op in str(r['raised']) and 'dp-aware' in str(r['raised'])


# ---------------------------------------------------------------------------
# the pure functions
# ---------------------------------------------------------------------------
def _pad_cases():
    z = lambda *s: np.arange(np.prod(s), dtype='float32').reshape(s)
    return {
        'ragged': (({'img': z(52, 4), 'table': z(200, 3)}, 8), {}),
        'divides': (({'img': z(48, 4)}, 8), {}),
        'forced': (({'img': z(48, 4)}, 8), dict(force_mask=True)),
        'skip': (({'img': z(52, 4), 'table': z(201, 3)}, 8),
                 dict(skip={'table'})),
        'target': (({'img': z(5, 4), 'aux': z(2, 3)}, 2),
                   dict(target=6, force_mask=True, batch_names={'img'})),
        'sizes_only': (({'img': z(52, 4)}, 8), dict(sizes_only=True)),
        'one': (({'img': z(5, 4), 'scalar': np.float32(2)}, 1),
                dict(force_mask=True)),
    }


@pytest.mark.parametrize('case', sorted(_pad_cases()))
def test_pad_ragged_batch_matches_jax(case):
    (feed, multiple), kw = _pad_cases()[case]
    rj, rt = {}, {}
    want = jpe.pad_ragged_batch(dict(feed), multiple, report=rj, **kw)
    got = tpe.pad_ragged_batch(dict(feed), multiple, report=rt, **kw)
    assert got[1:] == want[1:] and rt == rj
    if want[0] is None:
        assert got[0] is None
        return
    assert sorted(got[0]) == sorted(
        n.replace(jregistry.SAMPLE_MASK_NAME,
                  tfluid.executor.registry.SAMPLE_MASK_NAME)
        for n in want[0])
    for n, w in want[0].items():
        np.testing.assert_array_equal(np.asarray(got[0][n]), np.asarray(w),
                                      err_msg=n)


@pytest.mark.parametrize('bad', ['ambiguous', 'target_alone', 'names'])
def test_pad_ragged_batch_raises_like_jax(bad):
    z = lambda *s: np.zeros(s, 'float32')
    args = {'ambiguous': (({'a': z(52, 4), 'b': z(201, 4)}, 8), {}),
            'target_alone': (({'a': z(6, 4)}, 2), dict(target=8)),
            'names': (({'a': z(6, 4), 'b': z(5, 4)}, 1),
                      dict(batch_names={'a', 'b'}))}[bad]
    for pkg in (jpe, tpe):
        with pytest.raises(ValueError):
            pkg.pad_ragged_batch(dict(args[0][0]), args[0][1], **args[1])


def test_normalize_ragged_feed_list_matches_jax():
    rng = np.random.RandomState(3)
    lots = [{'img': rng.rand(n, 4).astype('float32'),
             'aux': rng.rand(2, 3).astype('float32')} for n in (6, 6, 5)]
    want = jpe.normalize_ragged_feed_list(
        [dict(l) for l in lots],
        lambda fa, **kw: jpe.pad_ragged_batch(fa, 2, **kw))
    got = tpe.normalize_ragged_feed_list(
        [dict(l) for l in lots],
        lambda fa, **kw: tpe.pad_ragged_batch(fa, 2, **kw))
    assert got[1:] == want[1:]
    for g, w in zip(got[0], want[0]):
        for n in w:
            np.testing.assert_array_equal(np.asarray(g[n]), np.asarray(w[n]))
    # lots that already agree come back as they are
    same = [{'img': rng.rand(4, 4).astype('float32')} for _ in range(2)]
    assert tpe.normalize_ragged_feed_list(
        same, lambda fa, **kw: tpe.pad_ragged_batch(fa, 2, **kw))[1:] == \
        (None, 4, None)


ENVS = [
    {'PADDLE_TRAINERS_NUM': '4', 'PADDLE_TRAINER_ID': '2',
     'PADDLE_TRAINER_ENDPOINTS':
         '10.0.0.1:7164,10.0.0.2:7164,10.0.0.3:7164,10.0.0.4:7164'},
    {'PADDLE_COORDINATOR': 'host0:1234', 'PADDLE_TRAINERS_NUM': '2',
     'PADDLE_TRAINER_ID': '0'},
    {},
    {'PADDLE_TRAINERS': '3', 'PADDLE_TRAINER_ID': '1',
     'PADDLE_MASTER_ENDPOINT': 'm:1', 'WORKER_TAG': 'w7'},
]


@pytest.mark.parametrize('env', range(len(ENVS)))
def test_parse_distributed_env_matches_jax(env):
    from paddle_tpu.parallel import multihost as jm
    from paddle_tpu_torch.parallel import multihost as tm
    e = ENVS[env]
    assert tm.parse_distributed_env(e) == jm.parse_distributed_env(e)
    assert tm.parse_elastic_env(e) == jm.parse_elastic_env(e)


def test_multihost_env_contract_like_jax(monkeypatch):
    """A multi-process env without a trainer id fails loudly; one process
    needs no coordinator; several without one raise."""
    for pkg in (jparallel, tparallel):
        with pytest.raises(ValueError):
            pkg.parse_distributed_env({'PADDLE_TRAINERS_NUM': '2'})
        assert pkg.init_distributed_env(num_processes=1) == (1, 0)
    for k in ('PADDLE_COORDINATOR', 'PADDLE_TRAINER_ENDPOINTS'):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match='coordinator'):
        tparallel.init_distributed_env(num_processes=2, process_id=0)


def _sparse_ctr(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name='ids', shape=[1], dtype='int64')
        emb = fluid.layers.embedding(ids, size=[1000, 8], is_sparse=True,
                                     is_distributed=True)
        dense = fluid.layers.embedding(ids, size=[50, 8])
        loss = fluid.layers.mean(fluid.layers.fc(
            fluid.layers.elementwise_add(emb, dense), 1))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _annotations(program):
    sharding_of = (tparallel.sharding_of if program.__module__.startswith(
        'paddle_tpu_torch') else jparallel.sharding_of)
    return {v.name: tuple(sharding_of(v)) for v in program.list_vars()
            if sharding_of(v) is not None}


def test_distribute_transpiler_annotates_and_stubs_like_jax():
    out = {}
    for name, fluid in (('jax', jfluid), ('torch', tfluid)):
        main, startup, _ = _sparse_ctr(fluid)
        t = fluid.DistributeTranspiler()
        with pytest.raises(RuntimeError):
            t.get_trainer_program()
        t.transpile(0, program=main, pservers='a:1,b:2', trainers=2,
                    startup_program=startup)
        pserver = t.get_pserver_program('a:1')
        out[name] = dict(
            tables=t.distributed_lookup_tables,
            has=t.has_distributed_lookup_table,
            main=_annotations(main), startup=_annotations(startup),
            same=t.get_trainer_program() is main,
            eps=t.pserver_endpoints,
            pserver=[(op.type, sorted(op.attrs)) for op in
                     pserver.global_block().ops],
            pair=[len(p.global_block().ops)
                  for p in t.get_pserver_programs('b:2')],
            remote=[op.attrs.get('remote_prefetch') for op in
                    main.global_block().ops if op.type == 'lookup_table'])
        with pytest.raises(NotImplementedError):
            fluid.DistributeTranspiler().transpile(0, program=main,
                                                   sync_mode=False)
    assert out['torch'] == out['jax']
    assert out['torch']['tables'] and out['torch']['main']


def test_a_transpiled_row_sharded_table_raises_in_parallel_executor():
    main, startup, loss = _sparse_ctr(tfluid)
    tfluid.DistributeTranspiler().transpile(0, program=main,
                                            startup_program=startup)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    with pytest.raises(NotImplementedError, match='item 7'):
        tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                main_program=main, scope=scope)


def test_sparse_gradients_under_dp_raise():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        ids = tfluid.layers.data(name='ids', shape=[1], dtype='int64')
        emb = tfluid.layers.embedding(ids, size=[100, 8], is_sparse=True)
        loss = tfluid.layers.mean(tfluid.layers.fc(emb, 1))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                 main_program=main, scope=scope)
    with pytest.raises(NotImplementedError, match='sparse'):
        pe.run([loss.name], feed={'ids': np.arange(4)[:, None]})


@pytest.mark.parametrize('names', [['a:1', 'b:2', 'c:3'], ['x:9']])
def test_ps_dispatchers_match_jax(names):
    from paddle_tpu.fluid.transpiler import ps_dispatcher as jd
    from paddle_tpu_torch.fluid.transpiler import ps_dispatcher as td
    vars_ = ['fc_0.w_0', 'fc_0.b_0', 'emb', 'x' * 40, 'fc_1.w_0']
    for cls in ('HashName', 'RoundRobin'):
        j, t = getattr(jd, cls)(names), getattr(td, cls)(names)
        assert t.dispatch(vars_) == j.dispatch(vars_)
        assert t.dispatch(vars_[:2]) == j.dispatch(vars_[:2])
        t.reset()
        j.reset()
        assert t.dispatch(vars_) == j.dispatch(vars_)
        assert t.eps == j.eps


# ---------------------------------------------------------------------------
# world size 1, in this process
# ---------------------------------------------------------------------------
def _start(fluid, model):
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(model['startup'], scope=scope)
    return scope


def _pair(build=mlp, **kw):
    """The same model in both packages from the JAX startup's state: (JAX
    ParallelExecutor on its 8 devices, the port's at world size 1, both
    models)."""
    jm, tm = build(jfluid, **kw), build(tfluid, **kw)
    jscope = _start(jfluid, jm)
    tscope = tfluid.Scope()
    tfluid.persistables_from_numpy(
        tm['main'], {n: np.asarray(jscope.find_var(n).value())
                     for n in _state_names(jm['main'])}, scope=tscope,
        place=tfluid.CPUPlace())
    jp = jfluid.ParallelExecutor(loss_name=jm['loss'],
                                 main_program=jm['main'], scope=jscope)
    tp = tfluid.ParallelExecutor(use_cuda=False, loss_name=tm['loss'],
                                 main_program=tm['main'], scope=tscope)
    return jp, tp, jm, tm


def _loss(v):
    return float(np.asarray(v).flatten()[0])


def test_parallel_executor_runs_and_converges():
    jp, tp, jm, tm = _pair(seed=0)
    assert tp.device_count == 1
    rng = np.random.RandomState(42)
    got, want = [], []
    for _ in range(40):
        b = mlp_batch(rng, 64)
        got.append(_loss(tp.run([tm['loss']], feed=b)[0]))
        want.append(_loss(jp.run([jm['loss']], feed=b)[0]))
    assert all(np.isfinite(got))
    assert got[-1] < got[0] * 0.85, (got[0], got[-1])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_parallel_matches_single_device():
    """The port's ParallelExecutor step equals its Executor's on the same
    batch, and the JAX package's ParallelExecutor's."""
    jp, tp, jm, tm = _pair()
    single = tm['main'].clone()
    sscope = tfluid.Scope()
    tfluid.persistables_from_numpy(
        single, {n: tp._scope.find_var(n).value().numpy()
                 for n in _state_names(tm['main'])}, scope=sscope,
        place=tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(3)
    for _ in range(5):
        b = mlp_batch(rng, 64)
        par = _loss(tp.run([tm['loss']], feed=b)[0])
        one = _loss(exe.run(single, feed=b, fetch_list=[tm['loss']],
                            scope=sscope)[0])
        assert par == one
        np.testing.assert_allclose(par, _loss(jp.run([jm['loss']],
                                                     feed=b)[0]),
                                   rtol=RTOL, atol=ATOL)


def test_ragged_final_batch_epoch_like_jax():
    """Four full lots and a ragged one: the same losses as the JAX
    ParallelExecutor, the ragged lot's fetch and the compile count (the
    full lots share one block, the ragged tail adds one)."""
    jp, tp, jm, tm = _pair(seed=3)
    rng = np.random.RandomState(1)
    for b in [mlp_batch(rng, 64) for _ in range(4)] + [mlp_batch(rng, 52)]:
        np.testing.assert_allclose(_loss(tp.run([tm['loss']], feed=b)[0]),
                                   _loss(jp.run([jm['loss']], feed=b)[0]),
                                   rtol=RTOL, atol=ATOL)
    assert tp.compile_count == jp.compile_count == 2


def test_run_multi_matches_sequential_steps_and_counts_like_jax():
    rng = np.random.RandomState(2)
    b = mlp_batch(rng, 64)
    jp, tp, jm, tm = _pair(seed=5)
    jp1, tp1, _, _ = _pair(seed=5)
    for _ in range(4):
        seq, = tp1.run([tm['loss']], feed=b)
    got, = tp.run_multi([tm['loss']], feed=b, steps=4)
    want, = jp.run_multi([jm['loss']], feed=b, steps=4)
    np.testing.assert_allclose(got, seq, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    for pe in (tp, jp):
        assert (pe.dispatch_count, pe.steps_dispatched, pe.compile_count) \
            == (1, 4, 2)
        pe.run_multi([tm['loss']], feed=b, steps=4)
        assert (pe.dispatch_count, pe.steps_dispatched, pe.compile_count) \
            == (2, 8, 2)


def test_run_multi_feed_list_with_a_ragged_tail_like_jax():
    rng = np.random.RandomState(4)
    batches = [mlp_batch(rng, 64) for _ in range(3)] + [mlp_batch(rng, 52)]
    jp, tp, jm, tm = _pair(seed=3)
    got, = tp.run_multi([tm['loss']], feed_list=batches)
    want, = jp.run_multi([jm['loss']], feed_list=batches)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    assert (tp.dispatch_count, tp.steps_dispatched) == \
        (jp.dispatch_count, jp.steps_dispatched) == (1, 4)


def test_run_eval_multi_like_jax():
    rng = np.random.RandomState(6)
    jp, tp, jm, tm = _pair(seed=3)
    lots = [mlp_batch(rng, 16), mlp_batch(rng, 13)]
    got = tp.run_eval_multi([tm['pred']], feed_list=lots)
    want = jp.run_eval_multi([jm['pred']], feed_list=lots)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)
    got = tp.run_eval_multi([tm['pred']], feed=lots[0], steps=2)
    want = jp.run_eval_multi([jm['pred']], feed=lots[0], steps=2)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=RTOL,
                               atol=ATOL)


def _extra_models():
    def weight_decay(fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 3
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data(name='img', shape=[56], dtype='float32')
            label = fluid.layers.data(name='label', shape=[1], dtype='int64')
            pred = fluid.layers.fc(input=img, size=10, act='softmax')
            ce = fluid.layers.mean(
                fluid.layers.cross_entropy(input=pred, label=label))
            wd = fluid.layers.mean(fluid.layers.square(
                main.all_parameters()[0]))
            loss = fluid.layers.elementwise_add(ce, wd)
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return dict(main=main, startup=startup, loss=loss.name,
                    pred=pred.name, wd=wd.name,
                    w=main.all_parameters()[0].name)

    def reduce_mean(fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 3
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data(name='img', shape=[64], dtype='float32')
            label = fluid.layers.data(name='label', shape=[1], dtype='int64')
            pred = fluid.layers.fc(input=img, size=10, act='softmax')
            loss = fluid.layers.reduce_mean(
                fluid.layers.cross_entropy(input=pred, label=label))
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return dict(main=main, startup=startup, loss=loss.name,
                    pred=pred.name)

    def aux(fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 3
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data(name='img', shape=[64], dtype='float32')
            label = fluid.layers.data(name='label', shape=[1], dtype='int64')
            tbl = fluid.layers.data(name='tbl', shape=[4], dtype='float32')
            pred = fluid.layers.fc(input=img, size=10, act='softmax')
            ce = fluid.layers.mean(
                fluid.layers.cross_entropy(input=pred, label=label))
            a = fluid.layers.mean(tbl)
            loss = fluid.layers.elementwise_add(ce, a)
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return dict(main=main, startup=startup, loss=loss.name,
                    pred=pred.name, aux=a.name)

    def flattened(fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 3
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data(name='img', shape=[64], dtype='float32')
            h = fluid.layers.fc(input=img, size=8)
            loss = fluid.layers.mean(fluid.layers.reshape(h, shape=[-1, 2]))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return dict(main=main, startup=startup, loss=loss.name,
                    pred=h.name)

    return dict(weight_decay=weight_decay, reduce_mean=reduce_mean, aux=aux,
                flattened=flattened)


def test_ragged_weight_decay_mean_is_not_masked_like_jax():
    build = _extra_models()['weight_decay']
    jp, tp, jm, tm = _pair(build)
    rng = np.random.RandomState(8)
    b = {'img': rng.standard_normal((52, 56)).astype('float32'),
         'label': rng.randint(0, 10, (52, 1)).astype('int64')}
    got = tp.run([tm['loss'], tm['wd'], tm['w'], tm['pred']], feed=b)
    want = jp.run([jm['loss'], jm['wd'], jm['w'], jm['pred']], feed=b)
    np.testing.assert_allclose(_loss(got[1]), _loss(want[1]), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(_loss(got[0]), _loss(want[0]), rtol=RTOL,
                               atol=ATOL)
    # a parameter fetch whose dim 0 is the padded rows stays whole, a
    # batch-led fetch comes back at the real rows
    assert got[2].shape == np.asarray(want[2]).shape == (56, 10)
    assert got[3].shape == np.asarray(want[3]).shape == (52, 10)


def test_ragged_reduce_mean_loss_like_jax():
    jp, tp, jm, tm = _pair(_extra_models()['reduce_mean'])
    b = mlp_batch(np.random.RandomState(9), 52)
    np.testing.assert_allclose(_loss(tp.run([tm['loss']], feed=b)[0]),
                               _loss(jp.run([jm['loss']], feed=b)[0]),
                               rtol=RTOL, atol=ATOL)


def test_coinciding_aux_feed_is_neither_masked_nor_trimmed_like_jax():
    jp, tp, jm, tm = _pair(_extra_models()['aux'])
    rng = np.random.RandomState(11)
    b = mlp_batch(rng, 52)
    b['tbl'] = rng.standard_normal((56, 4)).astype('float32')
    got = tp.run([tm['aux'], 'tbl'], feed=b)
    want = jp.run([jm['aux'], 'tbl'], feed=b)
    np.testing.assert_allclose(_loss(got[0]), _loss(want[0]), rtol=1e-6,
                               atol=1e-8)
    assert got[1].shape == np.asarray(want[1]).shape == (56, 4)


def test_flattened_batch_loss_warns_like_jax():
    import warnings
    jp, tp, jm, tm = _pair(_extra_models()['flattened'])
    b = {'img': np.random.RandomState(1).standard_normal(
        (52, 64)).astype('float32')}
    for pe, m in ((tp, tm), (jp, jm)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            pe.run([m['loss']], feed=b)
        assert any('flattened batch' in str(w.message).lower()
                   for w in caught)


def test_feed_list_errors_like_jax():
    """Mixed dtypes and mismatched names raise the uniformity errors; a
    reader-fed program is refused by the plain-feed path."""
    jp, tp, jm, tm = _pair()
    rng = np.random.RandomState(0)
    b1, b2 = mlp_batch(rng, 8), mlp_batch(rng, 8)
    b2['img'] = b2['img'].astype('float64')
    for pe, m in ((tp, tm), (jp, jm)):
        with pytest.raises(ValueError, match='dtypes|names'):
            pe.run_multi([m['loss']], feed_list=[b1, b2])
        with pytest.raises(ValueError, match='names'):
            pe.run_multi([m['loss']], feed_list=[
                mlp_batch(rng, 64), {'img': mlp_batch(rng, 52)['img']}])
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        reader = tfluid.layers.py_reader(
            capacity=4, shapes=[(-1, 64), (-1, 1)],
            dtypes=['float32', 'int64'], name='pe_torch_reader')
        img, _ = tfluid.layers.read_file(reader)
        loss = tfluid.layers.mean(tfluid.layers.fc(input=img, size=8))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                 main_program=main, scope=scope)
    with pytest.raises(RuntimeError, match='py_reader'):
        pe.run_multi([loss.name], feed={'img': np.zeros((8, 64), 'f4')},
                     steps=3)


# ---------------------------------------------------------------------------
# what this slice leaves out raises; what it needs does not
# ---------------------------------------------------------------------------
def test_parallel_executor_needs_a_card_unless_told(monkeypatch):
    import torch
    m = mlp(tfluid)
    scope = _start(tfluid, m)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        tfluid.ParallelExecutor(loss_name=m['loss'], main_program=m['main'],
                                scope=scope)


def _unported():
    def pe():
        m = mlp(tfluid)
        return tfluid.ParallelExecutor(use_cuda=False, loss_name=m['loss'],
                                       main_program=m['main'],
                                       scope=_start(tfluid, m))

    def annotated():
        m = mlp(tfluid)
        tparallel.shard(m['main'].all_parameters()[0], None, 'tp')
        tfluid.ParallelExecutor(use_cuda=False, loss_name=m['loss'],
                                main_program=m['main'],
                                scope=_start(tfluid, m))

    return {
        'mesh_tp': lambda: tparallel.make_mesh({'dp': 1, 'tp': 1}),
        'annotation_tp': annotated,
        'ring_attention': lambda: tparallel.ring_attention(None, None, None),
        'ulysses_attention': lambda: tparallel.ulysses_attention(None),
        'pipeline': lambda: tparallel.pipeline_spmd(None),
        'moe': lambda: tparallel.moe_ffn(None),
        'decode': lambda: pe().run_decode_multi(),
        'chunk_prefill': lambda: pe()._dispatch_chunk_prefill(),
        'reader_run_multi': lambda: pe().run_multi([], reader=object()),
        'feed_pipeline': lambda: tfluid.FeedPipeline(pe(), [], source=[]),
        'trainer': lambda: tfluid.Trainer(lambda: None, lambda: None,
                                          parallel=True),
    }


@pytest.mark.parametrize('case', sorted(_unported()))
def test_cases_left_out_of_this_slice_raise(case):
    with pytest.raises(NotImplementedError, match='ROADMAP|item'):
        _unported()[case]()


def test_host_op_programs_are_refused_like_jax():
    """A program holding a host op (``Print``) is refused, with the JAX
    package's error."""
    errors = []
    for fluid in (jfluid, tfluid):
        m = mlp(fluid)
        with fluid.program_guard(m['main'], m['startup']):
            fluid.layers.Print(m['main'].global_block().var(m['pred']))
        scope = _start(fluid, m)
        kw = {} if fluid is jfluid else dict(use_cuda=False)
        pe = fluid.ParallelExecutor(loss_name=m['loss'],
                                    main_program=m['main'], scope=scope,
                                    **kw)
        with pytest.raises(NotImplementedError, match='host ops') as e:
            pe.run([m['loss']], feed=mlp_batch(np.random.RandomState(0), 8))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_gloo_blocks_are_eager_and_the_counts_are_the_executors():
    """A one-rank ParallelExecutor on the CPU runs eagerly ('CPU place'),
    and its run_multi, run_eval_multi and cost report are the Executor's."""
    _, tp, _, tm = _pair()
    b = mlp_batch(np.random.RandomState(0), 8)
    tp.run_multi([tm['loss']], feed=b, steps=2)
    block, = tp.cached_blocks()
    assert block.mode == 'eager' and block.why == 'CPU place'
    assert tp.dp.world == 1 and tp.dp.calls == 0
    assert isinstance(tp.cost_report(), list)


if __name__ == '__main__':
    _worker(int(sys.argv[1]), 2, sys.argv[2], int(sys.argv[3]))
