"""Detection layers (counterpart of ``paddle_tpu/fluid/layers/detection.py``;
reference python/paddle/fluid/layers/detection.py): the SSD family
(prior_box, multi_box_head, bipartite_match, target_assign, ssd_loss,
detection_output, detection_map, iou_similarity, box_coder), the RPN
stages (anchor_generator, rpn_target_assign, generate_proposals,
generate_proposal_labels), polygon_box_transform and multiclass_nms.  Each
builds the JAX package's ops: ssd_loss is ONE fused op
(``ops/detection_ops.py``) where the reference composes 11, and
multiclass_nms, detection_map and the RPN sampling ops are host ops.
"""

from ..layer_helper import LayerHelper
from . import nn
from . import tensor
from ...ops.detection_ops import _expand_aspect_ratios

__all__ = [
    'prior_box', 'multi_box_head', 'bipartite_match', 'target_assign',
    'ssd_loss', 'detection_output', 'detection_map', 'iou_similarity',
    'box_coder', 'anchor_generator', 'rpn_target_assign',
    'polygon_box_transform', 'multiclass_nms',
    'generate_proposals', 'generate_proposal_labels',
]


def iou_similarity(x, y, name=None):
    """Pairwise IoU between box sets (reference detection.py __auto__;
    operators/detection/iou_similarity_op.cc)."""
    helper = LayerHelper('iou_similarity', **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type='iou_similarity',
        inputs={'X': [x],
                'Y': [y]},
        outputs={'Out': [out]})
    return out


def box_coder(prior_box,
              prior_box_var,
              target_box,
              code_type='encode_center_size',
              box_normalized=True,
              name=None):
    """Encode/decode boxes against priors (reference detection.py __auto__;
    operators/detection/box_coder_op.cc)."""
    helper = LayerHelper('box_coder', **locals())
    out = helper.create_variable_for_type_inference(dtype=target_box.dtype)
    inputs = {'PriorBox': [prior_box], 'TargetBox': [target_box]}
    if prior_box_var is not None:
        inputs['PriorBoxVar'] = [prior_box_var]
    helper.append_op(
        type='box_coder',
        inputs=inputs,
        outputs={'OutputBox': [out]},
        attrs={'code_type': code_type,
               'box_normalized': box_normalized})
    return out


def polygon_box_transform(input, name=None):
    """(reference detection.py __auto__; polygon_box_transform_op.cc)."""
    helper = LayerHelper('polygon_box_transform', **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type='polygon_box_transform',
        inputs={'Input': [input]},
        outputs={'Output': [out]})
    return out


def bipartite_match(dist_matrix,
                    match_type=None,
                    dist_threshold=None,
                    name=None):
    """Greedy bipartite matching (reference detection.py:392;
    operators/detection/bipartite_match_op.cc)."""
    helper = LayerHelper('bipartite_match', **locals())
    match_indices = helper.create_variable_for_type_inference(dtype='int32')
    match_distance = helper.create_variable_for_type_inference(
        dtype=dist_matrix.dtype)
    helper.append_op(
        type='bipartite_match',
        inputs={'DistMat': [dist_matrix]},
        attrs={
            'match_type': match_type if match_type is not None
            else 'bipartite',
            'dist_threshold': dist_threshold if dist_threshold is not None
            else 0.5,
        },
        outputs={
            'ColToRowMatchIndices': [match_indices],
            'ColToRowMatchDist': [match_distance],
        })
    match_indices.stop_gradient = True
    match_distance.stop_gradient = True
    return match_indices, match_distance


def target_assign(input,
                  matched_indices,
                  negative_indices=None,
                  mismatch_value=None,
                  name=None):
    """Assign per-prediction targets from matched rows (reference
    detection.py:477; operators/detection/target_assign_op.cc)."""
    helper = LayerHelper('target_assign', **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    out_weight = helper.create_variable_for_type_inference(dtype='float32')
    inputs = {'X': [input], 'MatchIndices': [matched_indices]}
    if negative_indices is not None:
        inputs['NegIndices'] = [negative_indices]
    helper.append_op(
        type='target_assign',
        inputs=inputs,
        outputs={'Out': [out],
                 'OutWeight': [out_weight]},
        attrs={'mismatch_value': mismatch_value or 0})
    out.stop_gradient = True
    out_weight.stop_gradient = True
    return out, out_weight


def ssd_loss(location,
             confidence,
             gt_box,
             gt_label,
             prior_box,
             prior_box_var=None,
             background_label=0,
             overlap_threshold=0.5,
             neg_pos_ratio=3.0,
             neg_overlap=0.5,
             loc_loss_weight=1.0,
             conf_loss_weight=1.0,
             match_type='per_prediction',
             mining_type='max_negative',
             normalize=True,
             sample_size=None):
    """SSD multibox loss (reference detection.py:563).  Returns a (N, 1)
    per-image weighted loss; fused single-op lowering
    (ops/detection_ops.py ssd_loss)."""
    if mining_type not in ('max_negative', 'hard_example'):
        raise ValueError('mining_type must be max_negative or hard_example')
    if mining_type == 'hard_example' and not sample_size:
        # reference enforce (mine_hard_examples_op.cc:238-240)
        raise ValueError(
            'sample_size must be greater than zero in hard_example mode')
    helper = LayerHelper('ssd_loss', **locals())
    loss = helper.create_variable_for_type_inference(dtype=location.dtype)
    inputs = {
        'Location': [location],
        'Confidence': [confidence],
        'GtBox': [gt_box],
        'GtLabel': [gt_label],
        'PriorBox': [prior_box],
    }
    if prior_box_var is not None:
        inputs['PriorBoxVar'] = [prior_box_var]
    helper.append_op(
        type='ssd_loss',
        inputs=inputs,
        outputs={'Loss': [loss]},
        attrs={
            'background_label': background_label,
            'overlap_threshold': overlap_threshold,
            'neg_pos_ratio': neg_pos_ratio,
            'neg_overlap': neg_overlap,
            'loc_loss_weight': loc_loss_weight,
            'conf_loss_weight': conf_loss_weight,
            'match_type': match_type,
            'mining_type': mining_type,
            'normalize': normalize,
            'sample_size': sample_size or 0,
        })
    return loss


def multiclass_nms(bboxes,
                   scores,
                   score_threshold,
                   nms_top_k,
                   keep_top_k,
                   nms_threshold=0.3,
                   nms_eta=1.0,
                   background_label=0,
                   name=None):
    """Per-class NMS + cross-class top-k (reference
    operators/detection/multiclass_nms_op.cc — CPU-only kernel; host op
    here).  Output is a LoD (num_kept, 6) tensor."""
    helper = LayerHelper('multiclass_nms', **locals())
    out = helper.create_variable_for_type_inference(dtype=bboxes.dtype)
    helper.append_op(
        type='multiclass_nms',
        inputs={'BBoxes': [bboxes],
                'Scores': [scores]},
        outputs={'Out': [out]},
        attrs={
            'background_label': background_label,
            'score_threshold': score_threshold,
            'nms_top_k': nms_top_k,
            'nms_threshold': nms_threshold,
            'nms_eta': nms_eta,
            'keep_top_k': keep_top_k,
        })
    out.stop_gradient = True
    return out


def detection_output(loc,
                     scores,
                     prior_box,
                     prior_box_var,
                     background_label=0,
                     nms_threshold=0.3,
                     nms_top_k=400,
                     keep_top_k=200,
                     score_threshold=0.01,
                     nms_eta=1.0):
    """Decode + multiclass NMS (reference detection.py:186): softmax the
    scores, decode loc offsets against priors, then NMS."""
    decoded = box_coder(
        prior_box=prior_box,
        prior_box_var=prior_box_var,
        target_box=loc,
        code_type='decode_center_size')
    probs = nn.softmax(scores)
    transposed = nn.transpose(probs, perm=[0, 2, 1])  # (N, C, M)
    return multiclass_nms(
        bboxes=decoded,
        scores=transposed,
        score_threshold=score_threshold,
        nms_top_k=nms_top_k,
        keep_top_k=keep_top_k,
        nms_threshold=nms_threshold,
        nms_eta=nms_eta,
        background_label=background_label)


def detection_map(detect_res,
                  label,
                  class_num,
                  background_label=0,
                  overlap_threshold=0.3,
                  evaluate_difficult=True,
                  has_state=None,
                  input_states=None,
                  out_states=None,
                  ap_version='integral'):
    """mAP metric (reference detection.py:300; detection_map_op.cc).
    With input_states/out_states (PosCount, TruePos, FalsePos variables)
    the op accumulates tp/fp entries across batches and reports the mAP of
    the accumulated state, gated by the has_state flag variable."""
    helper = LayerHelper('detection_map', **locals())
    map_out = helper.create_variable_for_type_inference(dtype='float32')
    inputs = {'DetectRes': [detect_res], 'Label': [label]}
    if has_state is not None:
        inputs['HasState'] = [has_state]
    # input_states are NOT op inputs: the host op reads accumulated state
    # straight from the scope vars named by the Accum* outputs, so the
    # executor never treats them as jit state needing initialization
    outputs = {'MAP': [map_out]}
    if out_states is not None:
        outputs['AccumPosCount'] = [out_states[0]]
        outputs['AccumTruePos'] = [out_states[1]]
        outputs['AccumFalsePos'] = [out_states[2]]
    elif input_states is not None:
        # reference semantics: states update in place when only inputs given
        outputs['AccumPosCount'] = [input_states[0]]
        outputs['AccumTruePos'] = [input_states[1]]
        outputs['AccumFalsePos'] = [input_states[2]]
    helper.append_op(
        type='detection_map',
        inputs=inputs,
        outputs=outputs,
        attrs={
            'overlap_threshold': overlap_threshold,
            'evaluate_difficult': evaluate_difficult,
            'ap_type': ap_version,
            'class_num': class_num,
            'background_label': background_label,
        })
    map_out.stop_gradient = True
    return map_out


def prior_box(input,
              image,
              min_sizes,
              max_sizes=None,
              aspect_ratios=[1.],
              variance=[0.1, 0.1, 0.2, 0.2],
              flip=False,
              clip=False,
              steps=[0.0, 0.0],
              offset=0.5,
              name=None):
    """SSD prior boxes for one feature map (reference detection.py:801;
    operators/detection/prior_box_op.cc)."""
    helper = LayerHelper('prior_box', **locals())

    def to_list(v):
        if v is None:
            return []
        return list(v) if isinstance(v, (list, tuple)) else [v]

    box = helper.create_variable_for_type_inference(dtype=input.dtype)
    var = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type='prior_box',
        inputs={'Input': [input],
                'Image': [image]},
        outputs={'Boxes': [box],
                 'Variances': [var]},
        attrs={
            'min_sizes': [float(v) for v in to_list(min_sizes)],
            'max_sizes': [float(v) for v in to_list(max_sizes)],
            'aspect_ratios': [float(v) for v in to_list(aspect_ratios)],
            'variances': [float(v) for v in variance],
            'flip': flip,
            'clip': clip,
            'step_w': float(steps[0]),
            'step_h': float(steps[1]),
            'offset': offset,
        })
    box.stop_gradient = True
    var.stop_gradient = True
    return box, var


def anchor_generator(input,
                     anchor_sizes=None,
                     aspect_ratios=None,
                     variance=[0.1, 0.1, 0.2, 0.2],
                     stride=None,
                     offset=0.5,
                     name=None):
    """RPN anchors for one feature map (reference detection.py:1167;
    operators/detection/anchor_generator_op.cc)."""
    helper = LayerHelper('anchor_generator', **locals())
    anchor = helper.create_variable_for_type_inference(dtype=input.dtype)
    var = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type='anchor_generator',
        inputs={'Input': [input]},
        outputs={'Anchors': [anchor],
                 'Variances': [var]},
        attrs={
            'anchor_sizes': [float(v) for v in anchor_sizes],
            'aspect_ratios': [float(v) for v in aspect_ratios],
            'variances': [float(v) for v in variance],
            'stride': [float(v) for v in stride],
            'offset': offset,
        })
    anchor.stop_gradient = True
    var.stop_gradient = True
    return anchor, var


def rpn_target_assign(loc,
                      scores,
                      anchor_box,
                      gt_box,
                      rpn_batch_size_per_im=256,
                      fg_fraction=0.25,
                      rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3,
                      fix_seed=False,
                      seed=0):
    """Sample anchors for RPN training (reference detection.py:58;
    rpn_target_assign_op.cc).  Returns (predicted_scores,
    predicted_location, target_label, target_bbox) index tensors."""
    helper = LayerHelper('rpn_target_assign', **locals())
    iou = iou_similarity(x=gt_box, y=anchor_box)
    loc_index = helper.create_variable_for_type_inference(dtype='int64')
    score_index = helper.create_variable_for_type_inference(dtype='int64')
    target_label = helper.create_variable_for_type_inference(dtype='int64')
    target_bbox = helper.create_variable_for_type_inference(
        dtype=anchor_box.dtype)
    helper.append_op(
        type='rpn_target_assign',
        inputs={'DistMat': [iou],
                'Anchor': [anchor_box],
                'GtBox': [gt_box]},
        outputs={
            'LocationIndex': [loc_index],
            'ScoreIndex': [score_index],
            'TargetLabel': [target_label],
            'TargetBBox': [target_bbox],
        },
        attrs={
            'rpn_batch_size_per_im': rpn_batch_size_per_im,
            'rpn_fg_fraction': fg_fraction,
            'rpn_positive_overlap': rpn_positive_overlap,
            'rpn_negative_overlap': rpn_negative_overlap,
            'fix_seed': fix_seed,
            'seed': seed,
        })
    for v in (loc_index, score_index, target_label, target_bbox):
        v.stop_gradient = True
    return loc_index, score_index, target_label, target_bbox


def multi_box_head(inputs,
                   image,
                   base_size,
                   num_classes,
                   aspect_ratios,
                   min_ratio=None,
                   max_ratio=None,
                   min_sizes=None,
                   max_sizes=None,
                   steps=None,
                   step_w=None,
                   step_h=None,
                   offset=0.5,
                   variance=[0.1, 0.1, 0.2, 0.2],
                   flip=True,
                   clip=False,
                   kernel_size=1,
                   pad=0,
                   stride=1,
                   name=None):
    """SSD detection head over multiple feature maps (reference
    detection.py:921): per-map conv heads for loc/conf + per-map priors,
    all flattened and concatenated.  Returns (mbox_locs, mbox_confs,
    prior_boxes, variances)."""
    helper = LayerHelper('multi_box_head', **locals())
    num_layer = len(inputs)

    if min_sizes is None:
        # reference: ratios interpolated between min_ratio and max_ratio
        assert num_layer >= 2, 'multi_box_head needs >= 2 inputs'
        min_sizes = []
        max_sizes = []
        step = int(
            (max_ratio - min_ratio) / (num_layer - 2)) if num_layer > 2 else 0
        min_sizes = [base_size * 0.1]
        max_sizes = [base_size * 0.2]
        for ratio in range(min_ratio, max_ratio + 1, step or 1):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = min_sizes[:num_layer]
        max_sizes = max_sizes[:num_layer]

    mbox_locs = []
    mbox_confs = []
    boxes = []
    variances = []
    for i, x in enumerate(inputs):
        min_size = min_sizes[i]
        max_size = max_sizes[i] if max_sizes else None
        if not isinstance(min_size, (list, tuple)):
            min_size = [min_size]
        if max_size is not None and not isinstance(max_size, (list, tuple)):
            max_size = [max_size]
        ar = aspect_ratios[i]
        if not isinstance(ar, (list, tuple)):
            ar = [ar]
        if steps is not None:
            step_pair = steps[i] if isinstance(steps[i],
                                               (list,
                                                tuple)) else [steps[i]] * 2
        else:
            step_pair = [step_w[i] if step_w else 0.0,
                         step_h[i] if step_h else 0.0]
        box, var = prior_box(x, image, min_size, max_size, ar, variance,
                             flip, clip, step_pair, offset)
        boxes.append(box)
        variances.append(var)
        # priors per cell, as ops/detection_ops.py _prior_box makes them
        ars = _expand_aspect_ratios(ar, flip)
        num_boxes = len(ars) * len(min_size) + len(max_size or [])

        loc = nn.conv2d(
            input=x,
            num_filters=num_boxes * 4,
            filter_size=kernel_size,
            padding=pad,
            stride=stride)
        loc = nn.transpose(loc, perm=[0, 2, 3, 1])
        loc = nn.reshape(loc, shape=[0, -1, 4])
        mbox_locs.append(loc)

        conf = nn.conv2d(
            input=x,
            num_filters=num_boxes * num_classes,
            filter_size=kernel_size,
            padding=pad,
            stride=stride)
        conf = nn.transpose(conf, perm=[0, 2, 3, 1])
        conf = nn.reshape(conf, shape=[0, -1, num_classes])
        mbox_confs.append(conf)

        boxes[-1] = nn.reshape(box, shape=[-1, 4])
        variances[-1] = nn.reshape(var, shape=[-1, 4])

    mbox_locs_concat = tensor.concat(mbox_locs, axis=1)
    mbox_confs_concat = tensor.concat(mbox_confs, axis=1)
    box_concat = tensor.concat(boxes, axis=0)
    var_concat = tensor.concat(variances, axis=0)
    for v in (box_concat, var_concat):
        v.stop_gradient = True
    return mbox_locs_concat, mbox_confs_concat, box_concat, var_concat


def generate_proposals(scores,
                       bbox_deltas,
                       im_info,
                       anchors,
                       variances,
                       pre_nms_top_n=6000,
                       post_nms_top_n=1000,
                       nms_thresh=0.5,
                       min_size=0.1,
                       eta=1.0,
                       name=None):
    """RPN proposal generation (reference detection.py:1317;
    generate_proposals_op.cc).  Returns (rpn_rois, rpn_roi_probs) LoD."""
    helper = LayerHelper('generate_proposals', **locals())
    rpn_rois = helper.create_variable_for_type_inference(
        dtype=bbox_deltas.dtype)
    rpn_roi_probs = helper.create_variable_for_type_inference(
        dtype=scores.dtype)
    helper.append_op(
        type='generate_proposals',
        inputs={
            'Scores': [scores],
            'BboxDeltas': [bbox_deltas],
            'ImInfo': [im_info],
            'Anchors': [anchors],
            'Variances': [variances],
        },
        outputs={'RpnRois': [rpn_rois],
                 'RpnRoiProbs': [rpn_roi_probs]},
        attrs={
            'pre_nms_topN': pre_nms_top_n,
            'post_nms_topN': post_nms_top_n,
            'nms_thresh': nms_thresh,
            'min_size': min_size,
            'eta': eta,
        })
    rpn_rois.stop_gradient = True
    rpn_roi_probs.stop_gradient = True
    return rpn_rois, rpn_roi_probs


def generate_proposal_labels(rpn_rois,
                             gt_classes,
                             is_crowd,
                             gt_boxes,
                             im_info,
                             batch_size_per_im=256,
                             fg_fraction=0.25,
                             fg_thresh=0.25,
                             bg_thresh_hi=0.5,
                             bg_thresh_lo=0.0,
                             bbox_reg_weights=[0.1, 0.1, 0.2, 0.2],
                             class_nums=None,
                             use_random=True):
    """Second-stage RoI sampling (reference detection.py:1259;
    generate_proposal_labels_op.cc).  Returns (rois, labels_int32,
    bbox_targets, bbox_inside_weights, bbox_outside_weights)."""
    helper = LayerHelper('generate_proposal_labels', **locals())
    rois = helper.create_variable_for_type_inference(dtype=rpn_rois.dtype)
    labels_int32 = helper.create_variable_for_type_inference(dtype='int32')
    bbox_targets = helper.create_variable_for_type_inference(
        dtype=rpn_rois.dtype)
    bbox_inside_weights = helper.create_variable_for_type_inference(
        dtype=rpn_rois.dtype)
    bbox_outside_weights = helper.create_variable_for_type_inference(
        dtype=rpn_rois.dtype)
    helper.append_op(
        type='generate_proposal_labels',
        inputs={
            'RpnRois': [rpn_rois],
            'GtClasses': [gt_classes],
            'IsCrowd': [is_crowd],
            'GtBoxes': [gt_boxes],
            'ImInfo': [im_info],
        },
        outputs={
            'Rois': [rois],
            'LabelsInt32': [labels_int32],
            'BboxTargets': [bbox_targets],
            'BboxInsideWeights': [bbox_inside_weights],
            'BboxOutsideWeights': [bbox_outside_weights],
        },
        attrs={
            'batch_size_per_im': batch_size_per_im,
            'fg_fraction': fg_fraction,
            'fg_thresh': fg_thresh,
            'bg_thresh_hi': bg_thresh_hi,
            'bg_thresh_lo': bg_thresh_lo,
            'bbox_reg_weights': bbox_reg_weights,
            'class_nums': class_nums or 81,
            'fix_seed': not use_random,
        })
    for v in (rois, labels_int32, bbox_targets, bbox_inside_weights,
              bbox_outside_weights):
        v.stop_gradient = True
    return (rois, labels_int32, bbox_targets, bbox_inside_weights,
            bbox_outside_weights)
