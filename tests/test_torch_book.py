"""The PyTorch port's book models and their data path held against the JAX
package on the CPU: the readers (``batch``, seeded ``shuffle``, ``firstn``,
``compose``, ``chain``) and the first 50 records of ``uci_housing``,
``movielens`` and ``conll05``; ``DataFeeder.feed`` (data, dtype and LoD)
on conll05, movielens and uci_housing minibatches; then ``fit_a_line``,
``recommender`` and ``label_semantic_roles`` (SRL at word_dim 4, hidden
8, depth 2 and 4, so that both LSTM directions are stacked): their
``build()`` ProgramDescs equal in main, startup and test, each test
program served and three SGD steps taken in parity, every batch fed
through its reader, ``batch`` and ``DataFeeder``, the state handed over
from the JAX scope before each step (``ModelParity``); fit_a_line's
inference model saved and loaded.

Tolerances (``ModelParity``, ratios of 2-norms; the same f32 arithmetic up
to summation order): loss and served fetches 1e-5, gradients and the
updated parameters 1e-4; a served Viterbi path exactly.
"""

import os
import random
import tempfile

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.fluid as jfluid
import paddle_tpu.reader as jreader
from paddle_tpu.dataset import conll05 as jconll05
from paddle_tpu.dataset import movielens as jmovielens
from paddle_tpu.dataset import uci_housing as juci
from paddle_tpu.models import fit_a_line as jax_fit
from paddle_tpu.models import label_semantic_roles as jax_srl
from paddle_tpu.models import recommender as jax_rec

import paddle_tpu_torch
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.reader as treader
from paddle_tpu_torch.fluid.shape_policy import bucketed_len
from paddle_tpu_torch.dataset import conll05 as tconll05
from paddle_tpu_torch.dataset import movielens as tmovielens
from paddle_tpu_torch.dataset import uci_housing as tuci
from paddle_tpu_torch.models import fit_a_line as torch_fit
from paddle_tpu_torch.models import label_semantic_roles as torch_srl
from paddle_tpu_torch.models import recommender as torch_rec

from test_torch_cv_ops import ModelParity, build_both

TOL = dict(loss=1e-5, grad=1e-4, grad_all=1e-4, accum=1e-4, stats=0.0,
           param=1e-4, serve=1e-5, null=0.0)
# conll05's columns, in the order DataFeeder takes them
SRL_FEEDS = ['word_data', 'ctx_n2_data', 'ctx_n1_data', 'ctx_0_data',
             'ctx_p1_data', 'ctx_p2_data', 'verb_data', 'mark_data',
             'target']


def _records(reader, n=50):
    return list(jreader.firstn(reader, n)())


def _same(got, want):
    """Records (nested tuples and lists of ints, floats and arrays) equal,
    element for element."""
    assert type(got) is type(want) or (
        isinstance(got, np.ndarray) and isinstance(want, np.ndarray))
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize('name, jreader_fn, treader_fn', [
    ('uci_housing.train', juci.train, tuci.train),
    ('uci_housing.test', juci.test, tuci.test),
    ('movielens.train', jmovielens.train, tmovielens.train),
    ('movielens.test', jmovielens.test, tmovielens.test),
    ('conll05.train', jconll05.train, tconll05.train),
    ('conll05.test', jconll05.test, tconll05.test),
])
def test_dataset_records_equal(name, jreader_fn, treader_fn):
    _same(_records(treader_fn()), _records(jreader_fn()))


def test_dataset_dicts_equal():
    assert tconll05.get_dict() == jconll05.get_dict()
    np.testing.assert_array_equal(tconll05.get_embedding(),
                                  jconll05.get_embedding())
    for fn in ('max_user_id', 'max_movie_id', 'max_job_id',
               'movie_categories'):
        assert getattr(tmovielens, fn)() == getattr(jmovielens, fn)()
    assert tmovielens.age_table == jmovielens.age_table


def test_readers_yield_what_jax_yields():
    jr, tr = juci.train(n=37), tuci.train(n=37)
    for drop_last in (False, True):
        _same(list(paddle_tpu_torch.batch(tr, 8, drop_last)()),
              list(paddle_tpu.batch(jr, 8, drop_last)()))
    _same(list(treader.firstn(tr, 5)()), list(jreader.firstn(jr, 5)()))
    random.seed(11)
    want = list(jreader.shuffle(jr, 10)())
    random.seed(11)
    _same(list(treader.shuffle(tr, 10)()), want)
    _same(list(treader.chain(treader.firstn(tr, 3), tr)()),
          list(jreader.chain(jreader.firstn(jr, 3), jr)()))
    _same(list(treader.compose(tr, tr)()), list(jreader.compose(jr, jr)()))
    _same(list(treader.buffered(tr, 4)()), list(jreader.buffered(jr, 4)()))


def _feeder(fluid, program, names):
    blk = program.global_block()
    return fluid.DataFeeder([blk.var(n) for n in names], fluid.CPUPlace(),
                            program=program)


def _minibatch(reader, size, index=0):
    for i, mb in enumerate(paddle_tpu_torch.batch(reader, size)()):
        if i == index:
            return mb


@pytest.mark.parametrize('model', ['srl', 'recommender', 'fit_a_line'])
def test_data_feeder_matches_jax(model):
    if model == 'srl':
        jm, tm = build_both(jax_srl, torch_srl)
        names, mb = SRL_FEEDS, _minibatch(tconll05.train(), 10)
    elif model == 'recommender':
        jm, tm = build_both(jax_rec, torch_rec)
        names, mb = tm['feeds'], _minibatch(tmovielens.train(), 64)
    else:
        jm, tm = build_both(jax_fit, torch_fit)
        names, mb = ['x', 'y'], _minibatch(tuci.train(), 20)
    want = _feeder(jfluid, jm['main'], names).feed(mb)
    got = _feeder(tfluid, tm['main'], names).feed(mb)
    assert sorted(got) == sorted(want) == sorted(names)
    lods = set()
    for n in names:
        g, w = got[n], want[n]
        assert isinstance(g, tfluid.LoDTensor), n
        assert g.lod() == w.lod(), n
        lods.add(tuple(map(tuple, g.lod())))
        a, b = g.numpy(), np.asarray(w)
        assert a.dtype == b.dtype and a.shape == b.shape, n
        np.testing.assert_array_equal(a, b, err_msg=n)
    if model == 'recommender':
        # category_id and movie_title: two LoD feeds of different LoD
        assert len(lods - {()}) == 2


def test_data_feeder_decorate_reader_and_parallel():
    """decorate_reader, and feed_parallel / decorate_reader(multi_devices)
    dealing a batch's samples to places, as the JAX package's do."""
    tm = torch_fit.build()
    feeder = _feeder(tfluid, tm['main'], ['x', 'y'])
    reader = paddle_tpu_torch.batch(tuci.train(n=45), 20)
    dicts = list(feeder.decorate_reader(reader)())
    assert [d['x'].shape() for d in dicts] == [[20, 13], [20, 13], [5, 13]]
    jfeeder = _feeder(jfluid, jax_fit.build()['main'], ['x', 'y'])
    jreader_ = paddle_tpu.batch(juci.train(n=45), 20)
    for got, want in (
            (feeder.feed_parallel(next(reader()), 3),
             jfeeder.feed_parallel(next(jreader_()), 3)),
            (list(feeder.decorate_reader(reader, multi_devices=True,
                                         num_places=2)()),
             list(jfeeder.decorate_reader(jreader_, multi_devices=True,
                                          num_places=2)()))):
        got = got if isinstance(got[0], dict) else sum(got, [])
        want = want if isinstance(want[0], dict) else sum(want, [])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for n in g:
                np.testing.assert_array_equal(g[n].numpy(),
                                              np.asarray(w[n]), err_msg=n)


def _book_feed(jm, tm, names, mb):
    """A ModelParity feed: the minibatch through each package's own
    DataFeeder."""
    return lambda fluid: _feeder(
        fluid, (jm if fluid is jfluid else tm)['main'], names).feed(mb)


def _step_and_serve(jm, tm, names, batches, serve_fetch, test_batch):
    parity = ModelParity(jm, tm)
    losses = [parity.step(_book_feed(jm, tm, names, mb), TOL)
              for mb in batches]
    assert np.all(np.isfinite(losses))
    got = parity.serve(_book_feed(jm, tm, names, test_batch), serve_fetch,
                       TOL)
    return parity, losses, got


@pytest.mark.parametrize('depth', [2, 4])
def test_srl_trains_and_serves_like_jax(depth):
    widths = dict(word_dict_len=4000, pred_dict_len=200, label_dict_len=59,
                  word_dim=4, hidden_dim=8, depth=depth, lr=0.01)
    jm, tm = build_both(jax_srl, torch_srl, **widths)
    lstms = [op for op in tm['main'].global_block().ops if op.type == 'lstm']
    assert [op.attrs['is_reverse'] for op in lstms] == \
        [bool(i % 2) for i in range(depth)]
    batches = list(treader.firstn(paddle_tpu_torch.batch(
        tconll05.train(), 6), 3)())
    test_batch = _minibatch(tconll05.test(), 6)
    _, _, (loss, path) = _step_and_serve(
        jm, tm, SRL_FEEDS, batches, [tm['loss'].name,
                                     tm['crf_decode'].name], test_batch)
    lengths = [len(r[0]) for r in test_batch]
    assert path.shape == (6, bucketed_len(max(lengths)), 1)
    assert path.max() < 59 and all(
        not path[i, n:].any() for i, n in enumerate(lengths))


def test_srl_default_build_matches_jax():
    build_both(jax_srl, torch_srl)


def test_recommender_trains_and_serves_like_jax():
    jm, tm = build_both(jax_rec, torch_rec)
    batches = list(treader.firstn(paddle_tpu_torch.batch(
        tmovielens.train(), 32), 3)())
    _, losses, (pred, ) = _step_and_serve(
        jm, tm, tm['feeds'], batches, [tm['prediction'].name],
        _minibatch(tmovielens.test(), 32))
    assert pred.shape == (32, 1) and np.abs(pred).max() <= 5.0 + 1e-5


def test_fit_a_line_trains_serves_and_round_trips_like_jax():
    jm, tm = build_both(jax_fit, torch_fit)
    batches = list(treader.firstn(paddle_tpu_torch.batch(
        tuci.train(), 20), 3)())
    test_batch = _minibatch(tuci.test(), 20)
    parity, _, (pred, ) = _step_and_serve(
        jm, tm, ['x', 'y'], batches, [tm['prediction'].name], test_batch)
    feed = _feeder(tfluid, tm['main'], ['x', 'y']).feed(test_batch)
    with tempfile.TemporaryDirectory() as d, \
            tfluid.scope_guard(parity.tscope):
        tfluid.io.save_inference_model(d, ['x'], [tm['prediction']],
                                       parity.texe, main_program=tm['main'])
        assert os.path.exists(os.path.join(d, '__model__'))
        prog, feed_names, fetch_targets = tfluid.io.load_inference_model(
            d, parity.texe)
        got, = parity.texe.run(prog, feed={feed_names[0]: feed['x']},
                               fetch_list=fetch_targets)
    np.testing.assert_allclose(got, pred, rtol=1e-5, atol=1e-6)
