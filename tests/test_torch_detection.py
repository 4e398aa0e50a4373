"""The PyTorch port's detection family held against the JAX package on the
CPU, on the same seeded numpy inputs:

- each of the 9 lowerings (``prior_box``, ``anchor_generator``,
  ``box_coder``, ``iou_similarity``, ``polygon_box_transform``,
  ``bipartite_match``, ``target_assign``, ``mine_hard_examples``,
  ``ssd_loss``) against the JAX lowering, and its generic grad
  (``torch.func.vjp``) against ``jax.vjp`` where it has float inputs that
  reach its outputs: both match types, both mining types, padded LoD ground
  truth with ``@SEQLEN``, and inputs with ties;
- each of the 5 host ops (``multiclass_nms``, ``detection_map``,
  ``rpn_target_assign``, ``generate_proposals``,
  ``generate_proposal_labels``) bit for bit, with their LoD: the empty-NMS
  sentinel, ``detection_map``'s accumulation across calls and its difficult
  rows, the RPN ops with ``fix_seed``;
- each of the 15 layers' ProgramDescs against the JAX layers';
- the 18 tests of ``tests/test_detection.py``, run on the port (the same
  source with the port's ``fluid``);
- the slice: ``chip_smoke.mobilenet_ssd_programs`` (path M's MobileNet-SSD)
  at scale 0.25 and 96 x 96, 21 classes: the same programs; the evaluation
  program over two batches of 2 with the map's state accumulating, against
  the JAX package's; two RMSProp steps of 8, each against the JAX
  package's step made f64 and run op by op (``STEP_BATCH`` says why 8,
  and the steps' test why op by op).

Tolerance: f32 outputs and gradients at rtol 1e-5 / atol 1e-6 (the
gradients' atol scaled by max(1, max|g|)); integer outputs exactly, by value
(the JAX package's int64 outputs come out int32); the host ops bitwise.
The slice's evaluation: the loss at rtol 1e-5, the detections at rtol 1e-5
/ atol 1e-6 with the same count, labels and LoD, the mAP exactly.  Its
steps: the port's step made f64 at rtol 1e-5 / atol 1e-6 (the priors
bitwise); the port's f32 step as their test states.
"""

import math
import os
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.ops import registry as jregistry

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import registry as tregistry

from test_torch_cv_ops import ModelParity, program_desc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from check_grad_f64 import f64_program  # noqa: E402
from chip_smoke import (one_op_program, one_op_grad_program,  # noqa: E402
                        op_out_names, op_rand, lod_tensor)

RTOL, ATOL = 1e-5, 1e-6
LOWERINGS = ['anchor_generator', 'bipartite_match', 'box_coder',
             'iou_similarity', 'mine_hard_examples', 'polygon_box_transform',
             'prior_box', 'ssd_loss', 'target_assign']
HOST_OPS = ['detection_map', 'generate_proposal_labels',
            'generate_proposals', 'multiclass_nms', 'rpn_target_assign']
LAYERS = ['anchor_generator', 'bipartite_match', 'box_coder',
          'detection_map', 'detection_output', 'generate_proposal_labels',
          'generate_proposals', 'iou_similarity', 'multi_box_head',
          'multiclass_nms', 'polygon_box_transform', 'prior_box',
          'rpn_target_assign', 'ssd_loss', 'target_assign']


def _same(name, got, want, exact=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if exact or want.dtype.kind in 'biu':
        # values, not dtypes: the JAX package's int64 comes out int32
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def _run(fluid, prog, feed, fetch, scope=None):
    return [np.asarray(o) for o in fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch, scope=scope or fluid.Scope())]


def _boxes(seed, n, lo=0.0, hi=1.0):
    """n seeded boxes [x1, y1, x2, y2] inside [lo, hi]^2."""
    r = np.sort(np.random.RandomState(seed).uniform(lo, hi, (n, 2, 2)),
                axis=1)
    return r.reshape(n, 4).astype('float32')


# ---- the registry ----

def test_the_slice_registers_9_lowerings_and_5_host_ops():
    for name in LOWERINGS:
        assert name in jregistry._LOWERINGS, name
        assert name in tregistry._LOWERINGS, name
    for name in HOST_OPS:
        assert tregistry.is_host_op_type(name), name
        assert jregistry.is_host_op_type(name), name
        assert tregistry.capture_refusal(
            type('Op', (), {'type': name, 'attrs': {}})()) is not None
    assert len(tregistry._HOST_OPS) == 7
    for name in LAYERS + ['detection']:
        assert hasattr(tfluid.layers, name), name
    assert sorted(tfluid.layers.detection.__all__) == sorted(LAYERS)


# ---- one-op lowerings on plain arrays, forward and generic grad ----

def _geometry_cases():
    prior = _boxes(1, 5)
    target = _boxes(2, 3)
    pvar = np.abs(op_rand(3, 5, 4)) + 0.1
    deltas = 0.2 * op_rand(4, 3, 5, 4)
    pixel = _boxes(5, 5, 0.0, 30.0)
    feat, img = op_rand(6, 1, 2, 3, 4), op_rand(7, 1, 3, 24, 32)
    ties = np.asarray([[0., 0., 2., 2.], [0., 0., 2., 2.], [1., 1., 3., 3.]],
                      'float32')
    return {
        'prior_box': ('prior_box', {'Input': ('f', feat), 'Image': ('i', img)},
                      {'Boxes': 'b', 'Variances': 'v'},
                      dict(min_sizes=[4.0, 9.0], max_sizes=[8.0, 14.0],
                           aspect_ratios=[2.0, 3.0, 2.0], flip=True,
                           clip=True, variances=[0.1, 0.1, 0.2, 0.2],
                           step_w=0.0, step_h=0.0, offset=0.5), None, ()),
        'prior_box_mm_order': (
            'prior_box', {'Input': ('f', feat), 'Image': ('i', img)},
            {'Boxes': 'b', 'Variances': 'v'},
            dict(min_sizes=[6.0], max_sizes=[12.0], aspect_ratios=[0.5],
                 flip=False, clip=False, step_w=7.0, step_h=5.0,
                 offset=0.25, min_max_aspect_ratios_order=True), None, ()),
        'anchor_generator': (
            'anchor_generator', {'Input': ('f', feat)},
            {'Anchors': 'a', 'Variances': 'v'},
            dict(anchor_sizes=[16.0, 40.0], aspect_ratios=[0.5, 1.0, 2.0],
                 variances=[1.0, 1.0, 1.0, 1.0], stride=[8.0, 6.0],
                 offset=0.5), None, ()),
        'box_coder_encode': (
            'box_coder', {'PriorBox': ('p', prior),
                          'PriorBoxVar': ('pv', pvar),
                          'TargetBox': ('t', target)}, {'OutputBox': 'o'},
            dict(code_type='encode_center_size'), 'o', ('p', 't')),
        'box_coder_encode_pixels': (
            'box_coder', {'PriorBox': ('p', pixel),
                          'TargetBox': ('t', target)}, {'OutputBox': 'o'},
            dict(code_type='encode_center_size', box_normalized=False), 'o',
            ('p', 't')),
        'box_coder_decode': (
            'box_coder', {'PriorBox': ('p', prior),
                          'PriorBoxVar': ('pv', pvar),
                          'TargetBox': ('t', deltas)}, {'OutputBox': 'o'},
            dict(code_type='decode_center_size'), 'o', ('p', 't', 'pv')),
        'box_coder_decode_2d': (
            'box_coder', {'PriorBox': ('p', pixel),
                          'TargetBox': ('t', deltas[0])}, {'OutputBox': 'o'},
            dict(code_type='decode_center_size', box_normalized=False), 'o',
            ('p', 't')),
        'iou_similarity': (
            'iou_similarity', {'X': ('x', _boxes(8, 4)), 'Y': ('y', prior)},
            {'Out': 'o'}, {}, 'o', ('x', 'y')),
        'iou_similarity_ties': (
            'iou_similarity', {'X': ('x', ties), 'Y': ('y', ties)},
            {'Out': 'o'}, {}, 'o', ('x', )),
        'polygon_box_transform': (
            'polygon_box_transform', {'Input': ('g', op_rand(9, 2, 4, 3, 5))},
            {'Output': 'o'}, {}, 'o', ('g', )),
    }


GEOMETRY = _geometry_cases()


@pytest.mark.parametrize('name', sorted(GEOMETRY))
def test_geometry_lowering_and_generic_grad_like_jax(name):
    case = GEOMETRY[name]
    want = _run(jfluid, *one_op_program(jfluid, *case[:4]),
                op_out_names(case[2]))
    got = _run(tfluid, *one_op_program(tfluid, *case[:4]),
               op_out_names(case[2]))
    for n, g, w in zip(op_out_names(case[2]), got, want):
        _same(n, g, w)
    if case[4] is None:
        return
    cot = np.random.RandomState(8).standard_normal(
        want[0].shape).astype('float32')
    want = _run(jfluid, *one_op_grad_program(jfluid, case, case[4], case[5],
                                             cot)[:2],
                [n + '@GRAD' for n in case[5]])
    got = _run(tfluid, *one_op_grad_program(tfluid, case, case[4], case[5],
                                            cot)[:2],
               [n + '@GRAD' for n in case[5]])
    for n, g, w in zip(case[5], got, want):
        assert np.abs(w).max() > 0, n
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=n + '@GRAD')


# ---- matching, assignment, mining and the fused loss ----

def _tied_dist():
    """Three instances' [G, M] distances as LoD rows: ties inside a row
    and across rows, a row that is all zeros, and fewer rows than G."""
    a = np.asarray([[0.5, 0.5, 0.2, 0.0], [0.5, 0.1, 0.5, 0.3],
                    [0.0, 0.0, 0.0, 0.0]], 'float32')
    b = np.asarray([[0.3, 0.3, 0.3, 0.3]], 'float32')
    c = np.random.RandomState(11).randint(0, 3, (5, 4)).astype(
        'float32') / 4
    return [a, b, c]


def _match_program(fluid, match_type, thr):
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        d = fluid.layers.data(name='d', shape=[4], dtype='float32',
                              lod_level=1)
        idx, dist = fluid.layers.bipartite_match(d, match_type, thr)
    return prog, [idx, dist]


@pytest.mark.parametrize('match_type,thr', [('bipartite', None),
                                            ('per_prediction', 0.25),
                                            ('per_prediction', 0.5)])
def test_bipartite_match_with_ties_and_padding_like_jax(match_type, thr):
    rows = _tied_dist()
    out = {}
    for fluid in (jfluid, tfluid):
        prog, fetch = _match_program(fluid, match_type, thr)
        out[fluid] = _run(fluid, prog,
                          {'d': lod_tensor(fluid, rows, 'float32')}, fetch)
    for n, g, w in zip(('indices', 'dist'), out[tfluid], out[jfluid]):
        _same(n, g, w, exact=True)
    if match_type == 'bipartite':
        # instance 1 has one row: one column matched, the first of the ties
        assert list(out[tfluid][0][1]) == [0, -1, -1, -1]


def _assign_program(fluid, with_neg):
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        x = fluid.layers.data(name='x', shape=[3], dtype='float32',
                              lod_level=1)
        m = fluid.layers.data(name='m', shape=[5], dtype='int32')
        neg = fluid.layers.data(name='neg', shape=[5], dtype='int32') \
            if with_neg else None
        out, w = fluid.layers.target_assign(x, m, negative_indices=neg,
                                            mismatch_value=-2.0)
    return prog, [out, w]


@pytest.mark.parametrize('with_neg', [False, True])
def test_target_assign_over_padded_rows_like_jax(with_neg):
    rows = [op_rand(12, 2, 3), op_rand(13, 4, 3)]
    feed = {'m': np.asarray([[1, -1, 0, 1, -1], [3, 2, -1, 0, 0]], 'int32'),
            'neg': np.asarray([[0, 1, 0, 0, 1], [0, 0, 1, 0, 0]], 'int32')}
    out = {}
    for fluid in (jfluid, tfluid):
        prog, fetch = _assign_program(fluid, with_neg)
        f = dict(feed, x=lod_tensor(fluid, rows, 'float32'))
        if not with_neg:
            f.pop('neg')
        out[fluid] = _run(fluid, prog, f, fetch)
    for n, g, w in zip(('out', 'weight'), out[tfluid], out[jfluid]):
        _same(n, g, w, exact=True)


def _mining_case(mining_type, sample_size):
    rng = np.random.RandomState(14)
    cls = rng.randint(0, 4, (3, 12)).astype('float32') / 2  # ties
    loc = rng.randint(0, 3, (3, 12)).astype('float32') / 4
    match = rng.randint(-1, 3, (3, 12)).astype('int32')
    match[:, :4] = -1
    dist = rng.randint(0, 5, (3, 12)).astype('float32') / 8
    return ('mine_hard_examples',
            {'ClsLoss': ('cls', cls[..., None]),
             'LocLoss': ('loc', loc[..., None]),
             'MatchIndices': ('match', match), 'MatchDist': ('dist', dist)},
            {'NegIndices': 'neg', 'UpdatedMatchIndices': 'upd'},
            dict(mining_type=mining_type, sample_size=sample_size,
                 neg_pos_ratio=1.5, neg_dist_threshold=0.4))


@pytest.mark.parametrize('mining_type,sample_size', [('max_negative', 0),
                                                     ('hard_example', 5)])
def test_mine_hard_examples_with_ties_like_jax(mining_type, sample_size):
    case = _mining_case(mining_type, sample_size)
    want = _run(jfluid, *one_op_program(jfluid, *case), op_out_names(case[2]))
    got = _run(tfluid, *one_op_program(tfluid, *case), op_out_names(case[2]))
    for n, g, w in zip(op_out_names(case[2]), got, want):
        _same(n, g, w, exact=True)
    assert want[0].sum() > 0


def test_mine_hard_examples_refuses_hard_example_without_a_sample_size():
    case = _mining_case('hard_example', 0)
    for fluid in (jfluid, tfluid):
        with pytest.raises(ValueError, match='sample_size'):
            _run(fluid, *one_op_program(fluid, *case), op_out_names(case[2]))


def _ssd_inputs():
    """Two images' [M, 4] locs and [M, C] confs over 12 priors, and their
    ground truth as LoD rows: 1 and 3 boxes (padded to G), two of the
    second image's boxes equal (ties in the IoU)."""
    priors = _boxes(15, 12)
    gt = [_boxes(16, 1), np.concatenate([_boxes(17, 2), _boxes(17, 1)])]
    labels = [np.asarray([[2]], 'int32'), np.asarray([[1], [3], [1]],
                                                     'int32')]
    return dict(loc=0.5 * op_rand(18, 2, 12, 4), conf=op_rand(19, 2, 12, 4),
                prior=priors, pvar=np.tile(np.asarray(
                    [0.1, 0.1, 0.2, 0.2], 'float32'), (12, 1))), gt, labels


def _ssd_program(fluid, **attrs):
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        L = fluid.layers
        loc = L.data(name='loc', shape=[12, 4], dtype='float32')
        conf = L.data(name='conf', shape=[12, 4], dtype='float32')
        loc.stop_gradient = conf.stop_gradient = False
        gtb = L.data(name='gtb', shape=[4], dtype='float32', lod_level=1)
        gtl = L.data(name='gtl', shape=[1], dtype='int32', lod_level=1)
        pb = L.data(name='prior', shape=[12, 4], dtype='float32',
                    append_batch_size=False)
        pbv = L.data(name='pvar', shape=[12, 4], dtype='float32',
                     append_batch_size=False)
        loss = L.ssd_loss(loc, conf, gtb, gtl, pb, pbv, **attrs)
        cot = prog.global_block().create_var(name='cot', shape=[2, 1],
                                             dtype='float32')
        fluid.backward.calc_gradient(targets=[loss], inputs=[loc, conf],
                                     target_gradients=[cot])
    return prog, [loss.name, 'loc@GRAD', 'conf@GRAD']


@pytest.mark.parametrize('attrs', [
    dict(), dict(match_type='bipartite'),
    dict(mining_type='hard_example', sample_size=5),
    dict(match_type='bipartite', mining_type='hard_example', sample_size=3,
         normalize=False, overlap_threshold=0.3, neg_overlap=0.2,
         loc_loss_weight=0.5, conf_loss_weight=2.0, background_label=1)],
    ids=['per_prediction-max_negative', 'bipartite-max_negative',
         'per_prediction-hard_example', 'bipartite-hard_example-attrs'])
def test_ssd_loss_and_its_grad_like_jax(attrs):
    arrays, gt, labels = _ssd_inputs()
    out = {}
    for fluid in (jfluid, tfluid):
        prog, fetch = _ssd_program(fluid, **attrs)
        feed = dict(arrays, gtb=lod_tensor(fluid, gt, 'float32'),
                    gtl=lod_tensor(fluid, labels, 'int32'),
                    cot=np.asarray([[1.0], [-0.5]], 'float32'))
        out[fluid] = _run(fluid, prog, feed, fetch)
    assert np.abs(out[jfluid][0]).min() > 0
    assert np.abs(out[jfluid][2]).max() > 0  # hard_example may keep no loc
    for n, g, w in zip(fetch, out[tfluid], out[jfluid]):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=n)


# ---- the host ops, bitwise ----

def _nms_program(fluid, **attrs):
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        b = fluid.layers.data(name='b', shape=[30, 4], dtype='float32')
        s = fluid.layers.data(name='s', shape=[4, 30], dtype='float32')
        out = fluid.layers.multiclass_nms(b, s, **attrs)
    return prog, out


@pytest.mark.parametrize('attrs', [
    dict(score_threshold=0.05, nms_top_k=10, keep_top_k=12,
         nms_threshold=0.3),
    dict(score_threshold=0.0, nms_top_k=-1, keep_top_k=-1, nms_threshold=0.5,
         nms_eta=0.9, background_label=2),
    dict(score_threshold=2.0, nms_top_k=5, keep_top_k=5)],
    ids=['top_k', 'eta', 'empty'])
def test_multiclass_nms_bitwise_like_jax(attrs):
    rng = np.random.RandomState(21)
    boxes = np.stack([_boxes(22, 30), _boxes(23, 30)])
    scores = rng.randint(0, 8, (2, 4, 30)).astype('float32') / 8  # ties
    out = {}
    for fluid in (jfluid, tfluid):
        prog, nms = _nms_program(fluid, **attrs)
        scope = fluid.Scope()
        got = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={'b': boxes, 's': scores}, fetch_list=[nms],
            scope=scope, return_numpy=False)[0]
        out[fluid] = (np.asarray(got), got.lod(),
                      scope.find_var(nms.name).value().lod())
    (g, g_lod, g_scope), (w, w_lod, w_scope) = out[tfluid], out[jfluid]
    _same('nms', g, w, exact=True)
    assert g.dtype == w.dtype and g_lod == w_lod and g_scope == w_scope
    if attrs['score_threshold'] > 1:
        # the reference's empty result: [1, 1] holding -1, one LoD row
        assert g.shape == (1, 1) and g[0, 0] == -1 and g_scope == [[0, 1]]


@pytest.mark.parametrize('eta', [1.0, 0.8])
def test_nms_one_class_bitwise_like_jax(eta):
    """The port's NMS against the JAX package's loop on 500 boxes with tied
    scores: the same kept indices."""
    from paddle_tpu.ops import detection_ops as jdet
    from paddle_tpu_torch.ops import detection_ops as tdet
    rng = np.random.RandomState(71)
    boxes = _boxes(72, 500)
    scores = rng.randint(0, 50, 500).astype('float32') / 50
    for thr, top_k in ((0.45, 400), (0.7, -1), (0.3, 50)):
        want = jdet._nms_one_class(boxes, scores, 0.05, top_k, thr, eta)
        got = tdet._nms_one_class(boxes, scores, 0.05, top_k, thr, eta)
        assert got == want and len(got) > 10


def _map_program(fluid, ap_version, evaluate_difficult, accumulate):
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        d = fluid.layers.data(name='d', shape=[6], dtype='float32',
                              lod_level=1)
        g = fluid.layers.data(name='g', shape=[6], dtype='float32',
                              lod_level=1)
        kw = {}
        if accumulate:
            states = [prog.global_block().create_var(
                name='st_%d' % i, persistable=True) for i in range(3)]
            kw = dict(has_state=fluid.layers.data(
                name='hs', shape=[1], dtype='int32'), input_states=states,
                out_states=states)
        m = fluid.layers.detection_map(
            d, g, class_num=4, overlap_threshold=0.4,
            evaluate_difficult=evaluate_difficult, ap_version=ap_version,
            **kw)
    return prog, m


def _map_batches(seed, n=3):
    """``n`` batches of two images: detections near the ground truth (and
    some far, some of the ground truth difficult), scores with ties."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        dets, gts = [], []
        for _ in range(2):
            k = rng.randint(1, 5)
            box = _boxes(rng.randint(1 << 20), k)
            gts.append(np.concatenate([
                rng.randint(1, 4, (k, 1)), box, rng.rand(k, 1) < 0.3],
                1).astype('float32'))
            jitter = box + 0.05 * rng.standard_normal(box.shape)
            far = _boxes(rng.randint(1 << 20), 2)
            dets.append(np.concatenate([
                np.concatenate([gts[-1][:, :1], rng.randint(1, 4, (2, 1))]),
                rng.randint(1, 5, (k + 2, 1)) / 4,
                np.concatenate([jitter, far])], 1).astype('float32'))
        out.append((dets, gts))
    return out


@pytest.mark.parametrize('ap_version', ['integral', '11point'])
@pytest.mark.parametrize('evaluate_difficult', [True, False])
def test_detection_map_accumulates_bitwise_like_jax(ap_version,
                                                    evaluate_difficult):
    out = {}
    for fluid in (jfluid, tfluid):
        prog, m = _map_program(fluid, ap_version, evaluate_difficult, True)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        got = []
        for i, (dets, gts) in enumerate(_map_batches(24)):
            got.append(np.asarray(exe.run(prog, feed={
                'd': lod_tensor(fluid, dets, 'float32'),
                'g': lod_tensor(fluid, gts, 'float32'),
                'hs': np.full((1, 1), int(i > 0), 'int32')},
                fetch_list=[m], scope=scope)[0]))
            got += [np.asarray(fluid.fetch_var('st_%d' % k, scope))
                    for k in range(3)]
        out[fluid] = got
    for i, (g, w) in enumerate(zip(out[tfluid], out[jfluid])):
        _same('call %d output %d' % (i // 4, i % 4), g, w, exact=True)
    # the accumulated mAP is not the last batch's alone
    single = {}
    for fluid in (jfluid, tfluid):
        prog, m = _map_program(fluid, ap_version, evaluate_difficult, False)
        dets, gts = _map_batches(24)[-1]
        single[fluid] = _run(fluid, prog, {
            'd': lod_tensor(fluid, dets, 'float32'),
            'g': lod_tensor(fluid, gts, 'float32')}, [m])[0]
    _same('one batch', single[tfluid], single[jfluid], exact=True)


def _rpn_feed(fluid, seed, lod):
    rng = np.random.RandomState(seed)
    anchors = _boxes(seed + 1, 40, 0.0, 64.0)
    gts = [_boxes(seed + 2, 2, 0.0, 64.0), _boxes(seed + 3, 3, 0.0, 64.0)]
    feed = {'anchor': anchors, 'loc': np.zeros((40, 4), 'float32'),
            'score': rng.rand(40, 1).astype('float32')}
    feed['gt'] = lod_tensor(fluid, gts, 'float32') if lod else gts[1]
    return feed


@pytest.mark.parametrize('lod', [False, True], ids=['one_image', 'batched'])
def test_rpn_target_assign_fix_seed_bitwise_like_jax(lod):
    out = {}
    for fluid in (jfluid, tfluid):
        prog = fluid.Program()
        with fluid.program_guard(prog, fluid.Program()):
            L = fluid.layers
            loc = L.data(name='loc', shape=[4], dtype='float32')
            score = L.data(name='score', shape=[1], dtype='float32')
            anchor = L.data(name='anchor', shape=[4], dtype='float32')
            gt = L.data(name='gt', shape=[4], dtype='float32',
                        lod_level=int(lod))
            fetch = L.rpn_target_assign(
                loc, score, anchor, gt, rpn_batch_size_per_im=12,
                fg_fraction=0.25, rpn_positive_overlap=0.3,
                rpn_negative_overlap=0.2, fix_seed=True, seed=5)
        out[fluid] = _run(fluid, prog, _rpn_feed(fluid, 30, lod), fetch)
    for n, g, w in zip(('loc', 'score', 'label', 'bbox'), out[tfluid],
                       out[jfluid]):
        _same(n, g, w, exact=True)
    assert out[tfluid][0].size and out[tfluid][1].size > out[tfluid][0].size


def test_generate_proposals_and_labels_bitwise_like_jax():
    """The RPN program of chip_smoke's path M3 at a 96 x 128 image (stride
    16: 6 x 8 cells, 15 anchors each), two images: every output bitwise,
    with the LoD of the proposals and the sampled RoIs."""
    cfg = dict(chip_smoke.RPN, image=(96, 128))
    out = {}
    for fluid in (jfluid, tfluid):
        model = chip_smoke.rpn_programs(fluid, cfg)
        scope = fluid.Scope()
        got = _run(fluid, model['program'], chip_smoke.rpn_feed(
            fluid, np.random.RandomState(31), cfg), model['fetch'],
            scope=scope)
        out[fluid] = got, [scope.find_var(n).value().lod()
                           for n in model['lod']]
    (got, lods), (want, want_lods) = out[tfluid], out[jfluid]
    for v, g, w in zip(model['fetch'], got, want):
        _same(v.name, g, w, exact=True)
    assert lods == want_lods
    assert got[0].shape == (6, 8, 15, 4) and got[2].shape[0] > 0
    # the sampled RoIs' labels: foreground and background
    assert (got[9] > 0).any() and (got[9] == 0).any()


# ---- the layers' ProgramDescs ----

def _layers(fluid):
    L = fluid.layers
    img = L.data(name='img', shape=[3, 32, 32], dtype='float32')
    f1 = L.conv2d(img, num_filters=4, filter_size=3, stride=4, padding=1)
    f2 = L.conv2d(f1, num_filters=4, filter_size=3, stride=2, padding=1)
    L.prior_box(f1, img, min_sizes=[4.0], max_sizes=[8.0],
                aspect_ratios=[2.0], flip=True, clip=True)
    L.prior_box(f2, img, min_sizes=[6.0, 9.0], steps=[8.0, 8.0], offset=0.3)
    locs, confs, boxes, variances = L.multi_box_head(
        inputs=[f1, f2], image=img, base_size=32, num_classes=3,
        aspect_ratios=[[2.0], [2.0, 3.0]], min_ratio=20, max_ratio=90,
        flip=True, clip=True)
    L.multi_box_head(inputs=[f1, f2], image=img, base_size=32,
                     num_classes=3, aspect_ratios=[2.0, 3.0],
                     min_sizes=[5.0, 10.0], max_sizes=[[], 16.0],
                     steps=[4.0, [8.0, 8.0]], kernel_size=3, pad=1)
    L.detection_output(locs, confs, boxes, variances, nms_threshold=0.45)
    gtb = L.data(name='gtb', shape=[4], dtype='float32', lod_level=1)
    gtl = L.data(name='gtl', shape=[1], dtype='int32', lod_level=1)
    L.ssd_loss(locs, confs, gtb, gtl, boxes, variances)
    L.ssd_loss(locs, confs, gtb, gtl, boxes, match_type='bipartite',
               mining_type='hard_example', sample_size=8, normalize=False)
    iou = L.iou_similarity(gtb, boxes)
    idx, _ = L.bipartite_match(iou, 'per_prediction', 0.3)
    L.bipartite_match(iou)
    L.target_assign(gtl, idx, mismatch_value=0)
    L.target_assign(gtb, idx, negative_indices=idx, mismatch_value=-1)
    enc = L.box_coder(boxes, variances, gtb)
    L.box_coder(boxes, None, enc, code_type='decode_center_size',
                box_normalized=False)
    L.polygon_box_transform(f1)
    d = L.data(name='det', shape=[6], dtype='float32', lod_level=1)
    g = L.data(name='lab', shape=[6], dtype='float32', lod_level=1)
    states = [L.create_tensor('float32', name='acc_%d' % i, persistable=True)
              for i in range(3)]
    L.detection_map(d, g, class_num=3)
    L.detection_map(d, g, class_num=3, background_label=-1,
                    overlap_threshold=0.6, evaluate_difficult=False,
                    has_state=L.data(name='hs', shape=[1], dtype='int32'),
                    input_states=states, out_states=states,
                    ap_version='11point')
    L.detection_map(d, g, class_num=3, input_states=states)
    L.multiclass_nms(locs, L.transpose(confs, perm=[0, 2, 1]),
                     score_threshold=0.1, nms_top_k=20, keep_top_k=10)
    anchors, avar = L.anchor_generator(f1, anchor_sizes=[8.0, 16.0],
                                       aspect_ratios=[0.5, 1.0],
                                       stride=[4.0, 4.0], offset=0.25)
    scores = L.data(name='sc', shape=[4, 8, 8], dtype='float32')
    deltas = L.data(name='dl', shape=[16, 8, 8], dtype='float32')
    im_info = L.data(name='im', shape=[3], dtype='float32')
    rois, _ = L.generate_proposals(scores, deltas, im_info, anchors, avar,
                                   pre_nms_top_n=100, post_nms_top_n=20)
    L.rpn_target_assign(deltas, scores, L.reshape(anchors, [-1, 4]), gtb,
                        fix_seed=True, seed=3)
    crowd = L.data(name='crowd', shape=[1], dtype='int32', lod_level=1)
    L.generate_proposal_labels(rois, gtl, crowd, gtb, im_info,
                               class_nums=5, use_random=False)


def test_layers_build_the_jax_program_desc():
    built = {}
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            _layers(fluid)
        built[fluid] = main, startup
    for j, t in zip(built[jfluid], built[tfluid]):
        assert program_desc(t) == program_desc(j)
    types_ = {op.type for op in built[tfluid][0].global_block().ops}
    # no layer builds mine_hard_examples: ssd_loss fuses it
    assert set(LOWERINGS + HOST_OPS) - types_ == {'mine_hard_examples'}


def test_every_layer_is_built_here():
    import inspect
    import re
    source = inspect.getsource(_layers)
    for name in LAYERS:
        assert re.search(r'\.%s\(' % name, source), name


# ---- tests/test_detection.py on the port ----

def _reference_tests():
    """``tests/test_detection.py`` compiled against the port: the same
    source, its ``fluid`` the port's and its ``lod_feed`` the port's
    LoDTensor."""
    path = os.path.join(REPO, 'tests', 'test_detection.py')
    src = open(path).read()
    assert src.count('import paddle_tpu.fluid as fluid') == 1
    assert src.count('from helpers import lod_feed') == 1
    src = src.replace('import paddle_tpu.fluid as fluid',
                      'import paddle_tpu_torch.fluid as fluid').replace(
        'from helpers import lod_feed',
        'lod_feed = lambda rows, dtype, dim=1: _lod(fluid, [\n'
        '    np.asarray(r, dtype).reshape(-1, dim) for r in rows], dtype)')
    mod = types.ModuleType('test_detection_on_the_port')
    mod._lod = lod_tensor
    exec(compile(src, path, 'exec'), mod.__dict__)
    return mod


PORTED = _reference_tests()
REFERENCE_TESTS = sorted(n for n in dir(PORTED) if n.startswith('test_'))


def test_the_reference_file_has_18_tests():
    assert len(REFERENCE_TESTS) == 18
    assert PORTED.fluid is tfluid


@pytest.mark.parametrize('name', REFERENCE_TESTS)
def test_reference_detection_test_on_the_port(name):
    getattr(PORTED, name)()


# ---- fetches, the executor and the dp guard ----

def test_a_host_ops_lod_output_reaches_the_next_host_op_and_the_fetch():
    """detection_output's LoD output feeds detection_map in one program
    (its ``@SEQLEN`` carried back by the executor's host-op walk), and the
    fetch is the JAX package's: the same array, a LoDTensor without LoD
    with ``return_numpy=False``, the scope's var holding the offsets."""
    priors = _boxes(42, 20)
    out = {}
    for fluid in (jfluid, tfluid):
        prog = fluid.Program()
        with fluid.program_guard(prog, fluid.Program()):
            L = fluid.layers
            loc = L.data(name='loc', shape=[20, 4], dtype='float32')
            conf = L.data(name='conf', shape=[20, 3], dtype='float32')
            pb = L.data(name='pb', shape=[4], dtype='float32')
            pv = L.data(name='pv', shape=[4], dtype='float32')
            gt = L.data(name='gt', shape=[6], dtype='float32', lod_level=1)
            nmsed = L.detection_output(loc, conf, pb, pv, score_threshold=0.3,
                                       nms_threshold=0.45)
            m = L.detection_map(nmsed, gt, class_num=3)
        scope = fluid.Scope()
        gts = [np.concatenate([np.ones((2, 1)), priors[:2], np.zeros((2, 1))],
                              1).astype('float32'),
               np.concatenate([np.full((1, 1), 2.0), priors[5:6],
                               np.zeros((1, 1))], 1).astype('float32')]
        got = fluid.Executor(fluid.CPUPlace()).run(prog, feed={
            'loc': 0.1 * op_rand(43, 2, 20, 4),
            'conf': 2 * op_rand(44, 2, 20, 3),
            'pb': priors, 'pv': np.full((20, 4), 0.1, 'float32'),
            'gt': lod_tensor(fluid, gts, 'float32')}, fetch_list=[nmsed, m],
            scope=scope, return_numpy=False)
        out[fluid] = ([np.asarray(g) for g in got], [g.lod() for g in got],
                      scope.find_var(nmsed.name).value().lod())
    (g, glod, gscope), (w, wlod, wscope) = out[tfluid], out[jfluid]
    np.testing.assert_allclose(g[0], w[0], rtol=RTOL, atol=ATOL)
    _same('map', g[1], w[1], exact=True)
    assert glod == wlod == [[], []] and gscope == wscope
    assert len(gscope[0]) == 3 and g[0].shape[0] > 2


def test_detection_ops_under_data_parallelism_raise():
    """None of the slice's ops is dp-aware or row-wise (ssd_loss normalizes
    by the whole batch's positives): under a ParallelExecutor the lowering
    raises, and so does a program with a host op."""
    arrays, gt, labels = _ssd_inputs()
    prog = tfluid.Program()
    startup = tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(prog, startup):
        L = tfluid.layers
        x = L.data(name='x', shape=[8], dtype='float32')
        loc = L.reshape(L.fc(x, 48), [-1, 12, 4])
        conf = L.reshape(L.fc(x, 48), [-1, 12, 4])
        gtb = L.data(name='gtb', shape=[4], dtype='float32', lod_level=1)
        gtl = L.data(name='gtl', shape=[1], dtype='int32', lod_level=1)
        pb = L.data(name='prior', shape=[12, 4], dtype='float32',
                    append_batch_size=False)
        pbv = L.data(name='pvar', shape=[12, 4], dtype='float32',
                     append_batch_size=False)
        loss = L.reduce_sum(L.ssd_loss(loc, conf, gtb, gtl, pb, pbv))
        test = prog.clone(for_test=True)
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    with tfluid.program_guard(test, tfluid.Program()):
        blk = test.global_block()
        nmsed = tfluid.layers.detection_output(
            *(blk.var(v.name) for v in (loc, conf, pb, pbv)))
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                 main_program=prog, scope=scope)
    feed = {'x': op_rand(45, 2, 8), 'prior': arrays['prior'],
            'pvar': arrays['pvar'], 'gtb': lod_tensor(tfluid, gt, 'float32'),
            'gtl': lod_tensor(tfluid, labels, 'int32')}
    with pytest.raises(NotImplementedError, match='ssd_loss'):
        pe.run([loss.name], feed=feed)
    pe = tfluid.ParallelExecutor(use_cuda=False, main_program=test,
                                 scope=scope)
    with pytest.raises(NotImplementedError, match='host ops'):
        pe.run([nmsed.name], feed=feed)


def test_cost_report_counts_the_detection_ops():
    """``fluid.trace.op_flops`` of the slice's ops from the shapes they ran
    at: the match's G passes over [B, G, M], mining's two a prior,
    ``ssd_loss``'s IoU, match, cross-entropy and per-prior terms; the
    geometry ops make data (0) or a few passes an output."""
    from paddle_tpu_torch.fluid import trace
    b, g, m, c = 2, 16, 12, 4
    prog, _ = _ssd_program(tfluid)
    ops = {op.type: op for op in prog.global_block().ops}
    shapes = {ops['ssd_loss'].input('Confidence')[0]: (b, m, c),
              ops['ssd_loss'].input('GtBox')[0]: (b, g, 4)}
    meta = {n: (shape, 0) for n, shape in shapes.items()}
    assert trace.op_flops(ops['ssd_loss'], meta) == \
        b * g * m * (14 + g) + b * m * (5 * c + 32)
    blk = tfluid.Program().global_block()
    for name, shape in (('d', (b, g, m)), ('cls', (b, m)), ('o', (m, 4))):
        blk.create_var(name=name, shape=shape, dtype='float32')
    match = blk.append_op(type='bipartite_match', inputs={'DistMat': ['d']},
                          outputs={'ColToRowMatchIndices': ['o']})
    mine = blk.append_op(type='mine_hard_examples',
                         inputs={'ClsLoss': ['cls']}, outputs={})
    prior = blk.append_op(type='prior_box', inputs={}, outputs={
        'Boxes': ['o']})
    coder = blk.append_op(type='box_coder', inputs={}, outputs={
        'OutputBox': ['o']})
    meta = {'d': ((b, g, m), 0), 'cls': ((b, m), 0), 'o': ((m, 4), 0)}
    assert trace.op_flops(match, meta) == g * b * g * m
    assert trace.op_flops(mine, meta) == 2 * b * m
    assert trace.op_flops(prior, meta) == 0
    assert trace.op_flops(coder, meta) == 8 * m * 4


# ---- the slice: path M's MobileNet-SSD at scale 0.25, 96 x 96 ----

SMALL = dict(scale=0.25, size=96, num_classes=21)
SMALL_BATCH = dict(size=SMALL['size'], num_classes=SMALL['num_classes'])
# the training step's batch.  At 96 x 96 the last three extra blocks' maps
# are 1 x 1, so a batch norm there sees one value an image a channel: at
# batch 2 its output is +-1 whatever its input, its running variance is
# the square of a difference of two near-equal values, and its gradient
# rounding noise that reaches every earlier layer, so that an f32 step
# cannot be held near the f64 step.  At batch 8 it can.
STEP_BATCH = 8
STEP_SEED = 61


def _ssd_models():
    built = {}
    for fluid in (jfluid, tfluid):
        with fluid.unique_name.guard():
            built[fluid] = chip_smoke.mobilenet_ssd_programs(fluid, **SMALL)
    return built[jfluid], built[tfluid]


def _ssd_feed(seed, batch, names=None):
    """A seeded batch for each package (each its own LoDTensors)."""
    return lambda fluid: {k: v for k, v in chip_smoke.ssd_batch(
        fluid, np.random.RandomState(seed), batch, **SMALL_BATCH)[0].items()
        if names is None or k in names}


def test_mobilenet_ssd_builds_the_jax_programs():
    jm, tm = _ssd_models()
    for key in ('main', 'startup', 'test'):
        assert program_desc(tm[key]) == program_desc(jm[key]), key
    ops = [op.type for op in tm['test'].global_block().ops]
    for op, n in (('depthwise_conv2d', 13), ('conv2d', 34),
                  ('batch_norm', 35), ('prior_box', 6), ('ssd_loss', 1),
                  ('multiclass_nms', 1), ('detection_map', 1)):
        assert ops.count(op) == n, op


def test_mobilenet_ssd_evaluates_like_jax():
    """The evaluation program from the JAX package's startup state over
    two batches of 2 with the map's state accumulating (eager in both
    packages: its host ops): the loss (the cloned ssd_loss, batch norm at
    its running statistics), the detections with their LoD, the mAP and
    the state as the JAX package's."""
    jm, tm = _ssd_models()
    model = ModelParity(jm, tm)
    model._sync()
    fetch = [tm['loss'].name, tm['nmsed'].name, tm['map'].name] + \
        tm['states']
    for i, seed in enumerate((51, 52)):
        jfeed, tfeed = model._feeds(_ssd_feed(seed, 2))
        outs = []
        for m, exe, scope, feed in (
                (jm, model.jexe, model.jscope, jfeed),
                (tm, model.texe, model.tscope, tfeed)):
            feed['has_state'] = np.full((1, ), int(i > 0), 'int32')
            got = exe.run(m['test'], feed=feed, fetch_list=fetch,
                          scope=scope)
            outs.append([np.asarray(g) for g in got] + [
                scope.find_var(m['nmsed'].name).value().lod()])
        want, got = outs
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        assert got[-1] == want[-1] and got[1].shape == want[1].shape
        assert got[1].shape[1] == 6 and got[1].shape[0] > 2
        np.testing.assert_array_equal(got[1][:, 0], want[1][:, 0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
        _same('mAP', got[2], want[2], exact=True)
        for n, g, w in zip(tm['states'], got[3:-1], want[3:-1]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=n)


def _f64_lod(lt):
    out = tfluid.core.LoDTensor(np.asarray(lt).astype(np.float64))
    out.set_lod(lt.lod())
    return out


def _f64_state(state):
    return {n: a.astype(np.float64) if a.dtype == np.float32 else a
            for n, a in state.items()}


def _jax_eager_f64_step(program, state, feed, fetch, monkeypatch):
    """The JAX package's step of ``program`` made f64, run op by op (its
    own path for a program with a host op, here without a jit inside an
    op either, where ``jnp.argmax`` takes the first of tied priors): the
    fetches and the scope after the step."""
    import jax
    import paddle_tpu.fluid.executor as jexecutor
    monkeypatch.setattr(jexecutor, '_is_host_op', lambda op: True)
    scope = jfluid.Scope()
    gt = feed['gt_box']
    with jax.enable_x64(True), jax.disable_jit():
        for name, a in _f64_state(state).items():
            scope.var(name).set_value(jax.numpy.asarray(a))
        feed = dict(feed, image=feed['image'].astype(np.float64),
                    gt_box=jfluid.create_lod_tensor(
                        np.asarray(gt).astype(np.float64),
                        gt.recursive_sequence_lengths(), jfluid.CPUPlace()))
        got = jfluid.Executor(jfluid.CPUPlace()).run(
            f64_program(program, jfluid.core), feed=feed, fetch_list=fetch,
            scope=scope)
        got = [np.asarray(g) for g in got]
    return got, {n: np.asarray(scope.find_var(n).value()) for n in state}


def test_mobilenet_ssd_two_rmsprop_steps_like_eager_jax_in_f64(monkeypatch):
    """Two RMSProp steps of STEP_BATCH from the JAX package's startup state
    (the second from the first's accumulators), each held from the
    reference's state before it.

    The reference is the JAX package's step made f64 and run op by op.
    Jitted, XLA may round the priors' coordinates and the IoU otherwise
    than the eager path, so that its match may take the other of two
    priors whose IoU ties exactly (a cell's ratio-r and ratio-1/r boxes);
    eager, it takes the first, as the port does.  The batches hold such
    ties.

    - The port's step made f64 against it: the priors bitwise, the loss,
      every gradient and, after the step, every persistable (parameters,
      RMSProp's accumulators, batch-norm statistics) at RTOL / ATOL.
    - The port's f32 step against it, as far as f32 rounding through 35
      batch norms allows: the loss within 1e-5; the gradients over all
      within 3e-2 (the cifar-20 bound) and each within 0.1 (|dg| / |g|),
      a gradient the reference holds at 0 being 0; the parameters and
      statistics as path M's card step is held against the CPU
      (``chip_smoke.SSD_TRAIN_TOL``): at most ``param_frac`` of the
      elements beyond lr / 10, none beyond twice RMSProp's largest step,
      the statistics within ``stats``."""
    from paddle_tpu_torch.ops import detection_ops as tdet
    jm, tm = _ssd_models()
    model = ModelParity(jm, tm)
    start = {n: np.asarray(model.jscope.find_var(n).value())
             for n in model.state}
    ssd = [op for op in tm['main'].global_block().ops
           if op.type == 'ssd_loss'][0]
    priors = ssd.input('PriorBox')[0]
    fetch = [tm['loss'].name] + [p + '@GRAD' for p in model.params]
    main64 = f64_program(tm['main'])
    tol = chip_smoke.SSD_TRAIN_TOL
    rel = lambda g, w: float(np.linalg.norm(np.asarray(g, np.float64) - w) /
                             np.linalg.norm(w))
    state, ties = start, 0
    for seed in (STEP_SEED, STEP_SEED + 1):
        jfeed, tfeed = model._feeds(_ssd_feed(seed, STEP_BATCH,
                                              tm['feeds']))
        want, want_state = _jax_eager_f64_step(jm['main'], state, jfeed,
                                               fetch + [priors], monkeypatch)
        scope64 = tfluid.Scope()
        tfluid.persistables_from_numpy(main64, _f64_state(state),
                                       scope=scope64, place=tfluid.CPUPlace())
        got = tfluid.Executor(tfluid.CPUPlace()).run(
            main64, feed=dict(tfeed, image=tfeed['image'].astype(np.float64),
                              gt_box=_f64_lod(tfeed['gt_box'])),
            fetch_list=fetch + [priors], scope=scope64)
        _same('priors', got[-1], want[-1], exact=True)
        for name, g, w in zip(fetch, got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        for name in model.state:
            np.testing.assert_allclose(
                scope64.find_var(name).value().numpy(), want_state[name],
                rtol=RTOL, atol=ATOL, err_msg=name)

        # exact ties where the match decides: a ground-truth box whose
        # largest IoU two priors share
        iou = tdet._iou_matrix(
            torch.tensor(np.asarray(tfeed['gt_box']).astype(np.float64)),
            torch.tensor(want[-1])).numpy()
        ties += sum(int((r == r.max()).sum() > 1) for r in iou
                    if r.max() > 0)

        tfluid.persistables_from_numpy(
            tm['main'], {n: a.astype(start[n].dtype)
                         for n, a in state.items()},
            scope=model.tscope, place=tfluid.CPUPlace())
        got = model.texe.run(tm['main'], feed=tfeed, fetch_list=fetch,
                             scope=model.tscope)
        assert rel(got[0], want[0]) <= 1e-5, (seed, got[0], want[0])
        assert math.sqrt(
            sum(np.square(np.asarray(g, np.float64) - w).sum()
                for g, w in zip(got[1:], want[1:-1])) /
            sum(np.square(w).sum() for w in want[1:-1])) <= 3e-2, seed
        for name, g, w in zip(model.params, got[1:], want[1:-1]):
            if not np.any(w):
                # a head whose priors nothing matched: no gradient at all
                assert not np.any(g), (seed, name)
            else:
                assert rel(g, w) <= 0.1, (seed, name, rel(g, w))
        n_far = n_all = 0
        for name in model.params:
            dp = np.abs(model.tscope.find_var(name).value().numpy() -
                        want_state[name])
            assert dp.max() <= tol['param_max'], (seed, name, dp.max())
            n_far += int((dp > tol['param_atol']).sum())
            n_all += dp.size
        assert n_far <= tol['param_frac'] * n_all, (seed, n_far, n_all)
        for name in model.stats:
            assert rel(model.tscope.find_var(name).value().numpy(),
                       want_state[name]) <= tol['stats'], (seed, name)
        state = {n: a.astype(np.float64 if start[n].dtype == np.float32
                             else start[n].dtype)
                 for n, a in want_state.items()}
    assert ties
