"""Detection op lowerings and host ops (counterpart of
``paddle_tpu/ops/detection_ops.py``; reference
paddle/fluid/operators/detection/).

* ``prior_box``, ``anchor_generator``, ``box_coder``, ``iou_similarity``
  and ``polygon_box_transform`` are static-shape math on the block's device.
* ``bipartite_match``, ``target_assign`` and ``mine_hard_examples`` run on
  the device over *batched, padded* ground truth: its LoD rows are a dense
  [B, G, ...] tensor with the per-instance valid counts in the ``@SEQLEN``
  side-band, as in the JAX package.  The greedy match is G steps of
  tensor ops with no host read, so a CUDA graph can hold it.
* ``ssd_loss`` is one fused lowering (match, assign, mine and the loss), as
  the JAX package fuses it where the reference composes 11 ops.  Its
  gradient is the generic ``torch.func.vjp``; the encoded targets and the
  target labels are detached, as the JAX package stops their gradients.
* ``multiclass_nms``, ``detection_map``, ``rpn_target_assign``,
  ``generate_proposals`` and ``generate_proposal_labels`` keep the
  reference's host placement (CPU kernels with variable-size LoD outputs
  there too) and run on numpy; with ``fix_seed`` the sampling ops draw
  from ``np.random.RandomState(seed)``, as the JAX package does.
"""

import math

import numpy as np
import torch

from .registry import register_lowering, register_host_op, SEQLEN_SUFFIX


# ---------------------------------------------------------------------------
# static-shape geometry
# ---------------------------------------------------------------------------


def _expand_aspect_ratios(aspect_ratios, flip):
    """ExpandAspectRatios (reference prior_box_op.h): dedup, keep 1.0 first,
    optionally add reciprocals."""
    out = [1.0]
    for ar in aspect_ratios:
        exists = any(abs(ar - o) < 1e-6 for o in out)
        if not exists:
            out.append(float(ar))
            if flip:
                out.append(1.0 / float(ar))
    return out


def _prior_whs(min_sizes, max_sizes, ars, mm_order):
    """Each cell's (w, h) prior sizes in pixels, in the reference's order
    (prior_box_op.h:113-170): with ``min_max_aspect_ratios_order`` false
    the ar != 1 boxes come after the min box and the sqrt(min*max) box
    last; with it true, min, then max, then the ar boxes."""
    whs = []
    for k, ms in enumerate(min_sizes):
        ar_boxes = [(ms * math.sqrt(ar), ms / math.sqrt(ar))
                    for ar in ars if abs(ar - 1.0) >= 1e-6]
        whs.append((ms, ms))
        big = []
        if max_sizes:
            s = math.sqrt(ms * max_sizes[k])
            big = [(s, s)]
        whs.extend(big + ar_boxes if mm_order else ar_boxes + big)
    return whs


def _cell_grid(feat_h, feat_w, n, offset, step_w, step_h, device):
    """Each cell's centre, broadcast to [H, W, n]."""
    f32 = torch.float32
    cx = (torch.arange(feat_w, dtype=f32, device=device) + offset) * step_w
    cy = (torch.arange(feat_h, dtype=f32, device=device) + offset) * step_h
    return (cx[None, :, None].expand(feat_h, feat_w, n),
            cy[:, None, None].expand(feat_h, feat_w, n))


def _const(values, device, dtype=torch.float32):
    """A 1-D tensor of ``values`` made on ``device`` by fills: a copy from
    host memory cannot run inside a CUDA graph capture."""
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device)
                        for v in values])


def _half_sizes(whs, device):
    return (_const([w / 2.0 for w, _ in whs], device),
            _const([h / 2.0 for _, h in whs], device))


def _variances(variances, like):
    return _const(variances, like.device).expand(like.shape)


@register_lowering('prior_box')
def _prior_box(ctx, op):
    x = ctx.get(op, 'Input')  # [N, C, H, W] feature map
    image = ctx.get(op, 'Image')  # [N, C, Him, Wim]
    a = op.attrs
    min_sizes = [float(s) for s in a['min_sizes']]
    max_sizes = [float(s) for s in a.get('max_sizes', []) or []]
    aspect_ratios = a.get('aspect_ratios', [1.0]) or [1.0]
    step_w = float(a.get('step_w', 0.0) or 0.0)
    step_h = float(a.get('step_h', 0.0) or 0.0)
    offset = float(a.get('offset', 0.5))
    feat_h, feat_w = int(x.shape[2]), int(x.shape[3])
    img_h, img_w = int(image.shape[2]), int(image.shape[3])
    if step_w == 0.0:
        step_w = float(img_w) / feat_w
    if step_h == 0.0:
        step_h = float(img_h) / feat_h
    whs = _prior_whs(min_sizes, max_sizes,
                     _expand_aspect_ratios(aspect_ratios,
                                           a.get('flip', False)),
                     bool(a.get('min_max_aspect_ratios_order', False)))
    cx, cy = _cell_grid(feat_h, feat_w, len(whs), offset, step_w, step_h,
                        x.device)
    bw, bh = _half_sizes(whs, x.device)
    boxes = torch.stack([(cx - bw) / img_w, (cy - bh) / img_h,
                         (cx + bw) / img_w, (cy + bh) / img_h],
                        dim=-1)  # [H, W, P, 4]
    if a.get('clip', False):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    ctx.set(op, 'Boxes', boxes)
    ctx.set(op, 'Variances', _variances(
        a.get('variances', [0.1, 0.1, 0.2, 0.2]), boxes))


@register_lowering('anchor_generator')
def _anchor_generator(ctx, op):
    """Unnormalized RPN anchors (reference anchor_generator_op.h): for each
    aspect ratio r and size s, w0 = round(sqrt(stride_w stride_h / r)),
    h0 = round(w0 r), scaled by s / stride."""
    x = ctx.get(op, 'Input')
    a = op.attrs
    anchor_sizes = [float(s) for s in a['anchor_sizes']]
    stride_w, stride_h = [float(s) for s in a['stride']][:2]
    whs = []
    for ar in (float(r) for r in a['aspect_ratios']):
        base_w = round(math.sqrt(stride_w * stride_h / ar))
        base_h = round(base_w * ar)
        for s in anchor_sizes:
            whs.append((s / stride_w * base_w, s / stride_h * base_h))
    cx, cy = _cell_grid(int(x.shape[2]), int(x.shape[3]), len(whs),
                        float(a.get('offset', 0.5)), stride_w, stride_h,
                        x.device)
    hw, hh = _half_sizes(whs, x.device)
    anchors = torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)
    ctx.set(op, 'Anchors', anchors)
    ctx.set(op, 'Variances', _variances(
        a.get('variances', [0.1, 0.1, 0.2, 0.2]), anchors))


def _box_wh(box, normalized):
    extra = 0.0 if normalized else 1.0
    return (box[..., 2] - box[..., 0] + extra,
            box[..., 3] - box[..., 1] + extra)


def _centres(box):
    return ((box[..., 2] + box[..., 0]) / 2.0,
            (box[..., 3] + box[..., 1]) / 2.0)


@register_lowering('box_coder')
def _box_coder(ctx, op):
    prior = ctx.get(op, 'PriorBox')  # [M, 4]
    prior_var = ctx.get(op, 'PriorBoxVar')  # optional [M, 4]
    target = ctx.get(op, 'TargetBox')
    normalized = op.attrs.get('box_normalized', True)
    pw, ph = _box_wh(prior, normalized)
    pcx, pcy = _centres(prior)
    if op.attrs.get('code_type', 'encode_center_size') == \
            'encode_center_size':
        # target [N, 4] against prior [M, 4] -> [N, M, 4]
        # (box_coder_op.h EncodeCenterSize)
        tw, th = _box_wh(target, normalized)
        tcx, tcy = _centres(target)
        out = torch.stack(
            [(tcx[:, None] - pcx[None, :]) / pw[None, :],
             (tcy[:, None] - pcy[None, :]) / ph[None, :],
             torch.log(torch.abs(tw[:, None] / pw[None, :])),
             torch.log(torch.abs(th[:, None] / ph[None, :]))], dim=-1)
        if prior_var is not None:
            out = out / prior_var[None, :, :]
    else:
        # decode: target [N, M, 4] against prior [M, 4] (DecodeCenterSize)
        t = target[None] if target.dim() == 2 else target
        if prior_var is not None:
            t = t * prior_var[None, :, :]
        w = torch.exp(t[..., 2]) * pw[None, :]
        h = torch.exp(t[..., 3]) * ph[None, :]
        cx = t[..., 0] * pw[None, :] + pcx[None, :]
        cy = t[..., 1] * ph[None, :] + pcy[None, :]
        extra = 0.0 if normalized else 1.0
        out = torch.stack([cx - w / 2.0, cy - h / 2.0,
                           cx + w / 2.0 - extra, cy + h / 2.0 - extra],
                          dim=-1)
    ctx.set(op, 'OutputBox', out)


def _iou_matrix(x, y, normalized=True):
    """Pairwise IoU (reference iou_similarity_op.h IOUSimilarityFunctor):
    x [..., N, 4], y [M, 4] -> [..., N, M]."""
    extra = 0.0 if normalized else 1.0
    area_x = (x[..., 2] - x[..., 0] + extra) * (x[..., 3] - x[..., 1] + extra)
    area_y = (y[..., 2] - y[..., 0] + extra) * (y[..., 3] - y[..., 1] + extra)
    xmin = torch.maximum(x[..., :, None, 0], y[..., None, :, 0])
    ymin = torch.maximum(x[..., :, None, 1], y[..., None, :, 1])
    xmax = torch.minimum(x[..., :, None, 2], y[..., None, :, 2])
    ymax = torch.minimum(x[..., :, None, 3], y[..., None, :, 3])
    inter = (torch.clamp_min(xmax - xmin + extra, 0.0) *
             torch.clamp_min(ymax - ymin + extra, 0.0))
    union = area_x[..., :, None] + area_y[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-10),
                       0.0)


@register_lowering('iou_similarity')
def _iou_similarity(ctx, op):
    # X [N, 4] or padded ground truth [B, G, 4]; Y [M, 4]
    ctx.set(op, 'Out', _iou_matrix(ctx.get(op, 'X'), ctx.get(op, 'Y')))


@register_lowering('polygon_box_transform')
def _polygon_box_transform(ctx, op):
    """(reference polygon_box_transform_op.cc): input [N, K*2, H, W] of
    offsets; even channels give column index * 4 - x, odd channels row
    index * 4 - x (EAST-style geometry maps)."""
    x = ctx.get(op, 'Input')
    _, c, h, w = x.shape
    col = torch.arange(w, dtype=x.dtype, device=x.device)[None, :].expand(
        h, w)
    row = torch.arange(h, dtype=x.dtype, device=x.device)[:, None].expand(
        h, w)
    is_x = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    base = torch.where(is_x, col[None, None], row[None, None]) * 4.0
    ctx.set(op, 'Output', base - x)


# ---------------------------------------------------------------------------
# matching, assignment and mining over batched padded ground truth
# ---------------------------------------------------------------------------


def _batched_gt(ctx, op, slot):
    """(value, valid counts) of a ground-truth input: a padded [B, G, ...]
    tensor and each instance's valid rows from the ``@SEQLEN`` side-band
    (all G when it has none).  A 2-D input without one is one instance."""
    names = op.input(slot)
    val = ctx.get(op, slot)
    if val is None:
        return None, None
    lens = ctx.env.get(names[0] + SEQLEN_SUFFIX) if names else None
    if val.dim() == 2 and lens is None:
        val = val[None]
    if lens is None:
        lens = torch.full((val.shape[0], ), val.shape[1], dtype=torch.int32,
                          device=val.device)
    return val, lens.to(device=val.device, dtype=torch.int32)


def _bipartite_match(dist, lens, match_type, overlap_threshold):
    """Greedy global-max bipartite matching (reference bipartite_match_op.cc
    BipartiteMatch) of every instance of a [B, G, M] distance matrix at
    once: G times, take each instance's largest entry not in a used row or
    column (the first in row-major order among equals, as ``jnp.argmax``
    takes it) and bind its row and column, while that entry is finite.
    Rows past an instance's count never match.  Returns the [B, M] int32
    matched row (-1: none) and its distance."""
    b, g, m = dist.shape
    dev = dist.device
    rows = torch.arange(g, device=dev)
    cols = torch.arange(m, device=dev)
    neg_inf = torch.full((), -math.inf, dtype=dist.dtype, device=dev)
    masked = torch.where((rows[None, :] < lens[:, None])[..., None], dist,
                         neg_inf)
    match_idx = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    match_dist = torch.zeros((b, m), dtype=dist.dtype, device=dev)
    row_used = torch.zeros((b, g), dtype=torch.bool, device=dev)
    col_used = torch.zeros((b, m), dtype=torch.bool, device=dev)
    for _ in range(g):
        cur = torch.where(row_used[:, :, None] | col_used[:, None, :],
                          neg_inf, masked).reshape(b, g * m)
        flat = torch.argmax(cur, dim=1)
        best = torch.gather(cur, 1, flat[:, None])[:, 0]
        ok = torch.isfinite(best)[:, None]
        r = flat // m
        hit_col = (cols[None, :] == (flat % m)[:, None]) & ok
        match_idx = torch.where(hit_col, r[:, None].to(torch.int32),
                                match_idx)
        match_dist = torch.where(hit_col, best[:, None], match_dist)
        row_used = row_used | ((rows[None, :] == r[:, None]) & ok)
        col_used = col_used | hit_col
    if match_type == 'per_prediction':
        # each column left unmatched takes its best row when that clears
        # the threshold (bipartite_match_op.cc ArgMaxMatch)
        best_val = torch.amax(masked, dim=1)
        best_row = torch.argmax(masked, dim=1).to(torch.int32)
        extra = ~col_used & (best_val >= overlap_threshold)
        match_idx = torch.where(extra, best_row, match_idx)
        match_dist = torch.where(extra, best_val, match_dist)
    return match_idx, match_dist


@register_lowering('bipartite_match')
def _bipartite_match_op(ctx, op):
    dist, lens = _batched_gt(ctx, op, 'DistMat')  # [B, G, M]
    match_idx, match_dist = _bipartite_match(
        dist, lens, op.attrs.get('match_type', 'bipartite'),
        float(op.attrs.get('dist_threshold', 0.5)))
    ctx.set(op, 'ColToRowMatchIndices', match_idx)
    ctx.set(op, 'ColToRowMatchDist', match_dist)


def _gather_rows(x, index):
    """x [B, G, ...] gathered on dim 1 at index [B, M] -> [B, M, ...]."""
    idx = index.long().reshape(index.shape + (1, ) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(index.shape + x.shape[2:]))


@register_lowering('target_assign')
def _target_assign(ctx, op):
    x, _ = _batched_gt(ctx, op, 'X')  # [B, G, K]
    match = ctx.get(op, 'MatchIndices')  # [B, M], -1 = unmatched
    neg = ctx.get(op, 'NegIndices')  # optional [B, M] negative mask
    gathered = _gather_rows(x, torch.clamp_min(match, 0))
    matched = (match >= 0)[:, :, None]
    out = torch.where(matched, gathered, torch.full(
        (), op.attrs.get('mismatch_value', 0), dtype=x.dtype,
        device=x.device))
    w = matched.to(torch.float32)
    if neg is not None:
        w = torch.maximum(w, (neg > 0)[:, :, None].to(torch.float32))
    ctx.set(op, 'Out', out)
    ctx.set(op, 'OutWeight', w)


def _descending_ranks(loss):
    """Each element's rank in its row by ``loss``, largest first; equal
    values keep their order (a stable sort, as ``jnp.argsort`` is)."""
    order = torch.argsort(-loss, dim=1, stable=True)
    pos = torch.arange(loss.shape[1], device=loss.device).expand_as(order)
    return torch.empty_like(order).scatter(1, order, pos)


def _mine_negatives(cls_loss, loc_loss, match, match_dist, neg_pos_ratio,
                    neg_dist_threshold, sample_size, mining_type):
    """The negatives as a [B, M] bool mask (the static-shape stand-in for
    the reference's NegIndices LoD list) and the match indices after
    mining (reference mine_hard_examples_op.cc).

    max_negative: the unmatched priors whose match overlap is below
    ``neg_dist_threshold``, the top neg_pos_ratio * num_pos of them by
    confidence loss.  hard_example: every prior is eligible
    (IsEligibleMining, :34), ranked by cls + loc loss (:95-99), the top
    ``sample_size`` (:113); the selected unmatched ones are the negatives
    and the matched ones not selected are demoted to -1 (:125-132)."""
    if mining_type == 'hard_example':
        loss = cls_loss + (loc_loss if loc_loss is not None else 0.0)
        sel = _descending_ranks(loss) < min(int(sample_size), loss.shape[1])
        keep = sel & (match < 0)
        updated = torch.where((match >= 0) & ~sel,
                              torch.full_like(match, -1), match)
        return keep, updated
    is_neg_cand = (match < 0) & (match_dist < neg_dist_threshold)
    num_pos = torch.sum((match >= 0).to(torch.int32), dim=1)
    num_neg = (num_pos.to(torch.float32) * neg_pos_ratio).to(torch.int32)
    masked = torch.where(is_neg_cand, cls_loss,
                         torch.full((), -math.inf, dtype=cls_loss.dtype,
                                    device=cls_loss.device))
    keep = (_descending_ranks(masked) < num_neg[:, None]) & is_neg_cand
    return keep, match


@register_lowering('mine_hard_examples')
def _mine_hard_examples(ctx, op):
    cls_loss = ctx.get(op, 'ClsLoss')
    loc_loss = ctx.get(op, 'LocLoss')
    if cls_loss.dim() == 3:
        cls_loss = cls_loss[..., 0]
    if loc_loss is not None and loc_loss.dim() == 3:
        loc_loss = loc_loss[..., 0]
    mining_type = op.attrs.get('mining_type', 'max_negative')
    sample_size = int(op.attrs.get('sample_size', 0))
    if mining_type == 'hard_example' and sample_size <= 0:
        # reference enforce (mine_hard_examples_op.cc:238-240)
        raise ValueError(
            'sample_size must be greater than zero in hard_example mode')
    neg_mask, updated = _mine_negatives(
        cls_loss, loc_loss, ctx.get(op, 'MatchIndices'),
        ctx.get(op, 'MatchDist'),
        float(op.attrs.get('neg_pos_ratio', 1.0)),
        float(op.attrs.get('neg_dist_threshold', 0.5)), sample_size,
        mining_type)
    ctx.set(op, 'NegIndices', neg_mask.to(torch.int32))
    ctx.set(op, 'UpdatedMatchIndices', updated)


@register_lowering('ssd_loss')
def _ssd_loss(ctx, op):
    """The SSD multibox loss fused in one lowering (reference composes it
    from 11 ops in layers/detection.py ssd_loss:563): match the priors to
    the ground truth by IoU, assign each its label and encoded box, take
    the softmax cross-entropy and smooth-L1 losses, mine the negatives and
    weigh.  Returns the [B, 1] per-image loss."""
    loc = ctx.get(op, 'Location')  # [B, M, 4]
    conf = ctx.get(op, 'Confidence')  # [B, M, C]
    gt_box, lens = _batched_gt(ctx, op, 'GtBox')  # [B, G, 4]
    gt_label, _ = _batched_gt(ctx, op, 'GtLabel')  # [B, G, 1]
    prior_box = ctx.get(op, 'PriorBox')  # [M, 4]
    prior_var = ctx.get(op, 'PriorBoxVar')  # optional
    a = op.attrs
    mining_type = a.get('mining_type', 'max_negative')
    if gt_label.dim() == 3:
        gt_label = gt_label[..., 0]

    # 1. match the priors to the ground truth by IoU
    match, match_dist = _bipartite_match(
        _iou_matrix(gt_box, prior_box), lens,
        a.get('match_type', 'per_prediction'),
        float(a.get('overlap_threshold', 0.5)))
    safe = torch.clamp_min(match, 0)
    matched = match >= 0

    # 2. targets: each prior's label and its matched box encoded
    tgt_label = torch.where(
        matched, _gather_rows(gt_label.long(), safe),
        int(a.get('background_label', 0))).detach()  # [B, M]
    matched_box = _gather_rows(gt_box, safe)  # [B, M, 4]
    pw, ph = _box_wh(prior_box, True)
    pcx, pcy = _centres(prior_box)
    tcx, tcy = _centres(matched_box)
    tw, th = _box_wh(matched_box, True)
    eps = 1e-10
    enc = torch.stack(
        [(tcx - pcx[None]) / pw[None], (tcy - pcy[None]) / ph[None],
         torch.log(torch.clamp_min(torch.abs(tw / pw[None]), eps)),
         torch.log(torch.clamp_min(torch.abs(th / ph[None]), eps))],
        dim=-1)
    if prior_var is not None:
        enc = enc / prior_var[None, :, :]

    # 3. confidence loss (softmax cross-entropy), for mining and the loss
    logp = torch.log_softmax(conf, dim=-1)
    conf_loss = -torch.gather(logp, -1, tgt_label[..., None])[..., 0]

    # 4. smooth-L1 localization loss per prior, before mining, so that
    # hard_example mines on cls + loc loss as the reference pipeline does
    diff = loc - enc.detach()
    abs_diff = torch.abs(diff)
    loc_loss_all = torch.sum(torch.where(abs_diff < 1.0, 0.5 * diff * diff,
                                         abs_diff - 0.5), dim=-1)

    # 5. hard negative mining; hard_example may demote matched priors
    neg_mask, updated = _mine_negatives(
        conf_loss, loc_loss_all if mining_type == 'hard_example' else None,
        match, match_dist, float(a.get('neg_pos_ratio', 3.0)),
        float(a.get('neg_overlap', 0.5)), int(a.get('sample_size', 0) or 0),
        mining_type)
    matched = updated >= 0
    loss = (float(a.get('loc_loss_weight', 1.0)) * loc_loss_all *
            matched.to(loc.dtype) +
            float(a.get('conf_loss_weight', 1.0)) * conf_loss *
            (matched | neg_mask).to(conf.dtype))  # [B, M]
    if a.get('normalize', True):
        loss = loss / torch.clamp_min(torch.sum(matched.to(loss.dtype)), 1.0)
    ctx.set(op, 'Loss', torch.sum(loss, dim=1, keepdim=True))


# ---------------------------------------------------------------------------
# host post-processing (CPU-only kernels in the reference, too)
# ---------------------------------------------------------------------------


def _scope_array(value):
    """A scope var's value (a tensor, a LoDTensor or an array) as numpy."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _set_lod_output(ctx, scope, name, arr, lod):
    """A host op's LoD output: the scope var holds it as a LoDTensor with
    its offsets, the environment as an array with its ``@SEQLEN``."""
    from ..fluid import core
    lt = core.LoDTensor(torch.as_tensor(arr))
    lt.set_lod([lod])
    scope.var(name).set_value(lt)
    ctx.store(name, arr)
    ctx.env[name + SEQLEN_SUFFIX] = np.diff(np.asarray(lod))


def _nms_one_class(boxes, scores, score_threshold, nms_top_k, nms_threshold,
                   nms_eta):
    """Greedy NMS over one class (reference multiclass_nms_op.cc NMSFast):
    the kept indices into ``boxes``.  The candidates above the threshold,
    by score (a stable sort), the first ``nms_top_k``; each in turn is
    kept and drops the rest that overlap it by more than the (adaptive)
    threshold."""
    idx = np.where(scores > score_threshold)[0]
    if idx.size == 0:
        return []
    idx = idx[np.argsort(-scores[idx], kind='stable')]
    if nms_top_k > -1 and idx.size > nms_top_k:
        idx = idx[:nms_top_k]
    keep = []
    adaptive_threshold = nms_threshold
    while idx.size > 0:
        i = idx[0]
        keep.append(int(i))
        if idx.size == 1:
            break
        rest = idx[1:]
        bi = boxes[i]
        area_i = max(bi[2] - bi[0], 0) * max(bi[3] - bi[1], 0)
        br = boxes[rest]
        iw = np.maximum(
            np.minimum(bi[2], br[:, 2]) - np.maximum(bi[0], br[:, 0]), 0)
        ih = np.maximum(
            np.minimum(bi[3], br[:, 3]) - np.maximum(bi[1], br[:, 1]), 0)
        inter = iw * ih
        area_r = np.maximum(br[:, 2] - br[:, 0], 0) * np.maximum(
            br[:, 3] - br[:, 1], 0)
        union = area_i + area_r - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-10), 0)
        idx = rest[iou <= adaptive_threshold]
        if nms_eta < 1.0 and adaptive_threshold > 0.5:
            adaptive_threshold *= nms_eta
    return keep


@register_host_op('multiclass_nms')
def _multiclass_nms(ctx, op, scope):
    bboxes = np.asarray(ctx.get(op, 'BBoxes'))  # [B, M, 4]
    scores = np.asarray(ctx.get(op, 'Scores'))  # [B, C, M]
    a = op.attrs
    background_label = int(a.get('background_label', 0))
    score_threshold = float(a['score_threshold'])
    nms_top_k = int(a.get('nms_top_k', -1))
    nms_threshold = float(a.get('nms_threshold', 0.3))
    nms_eta = float(a.get('nms_eta', 1.0))
    keep_top_k = int(a.get('keep_top_k', -1))
    all_out = []
    lod = [0]
    for b in range(bboxes.shape[0]):
        dets = []  # (label, score, box index)
        for c in range(scores.shape[1]):
            if c == background_label:
                continue
            keep = _nms_one_class(bboxes[b], scores[b, c], score_threshold,
                                  nms_top_k, nms_threshold, nms_eta)
            for i in keep:
                dets.append((c, scores[b, c, i], i))
        if keep_top_k > -1 and len(dets) > keep_top_k:
            dets.sort(key=lambda d: -d[1])
            dets = dets[:keep_top_k]
        for c, s, i in dets:
            all_out.append([float(c), float(s)] + list(bboxes[b, i]))
        lod.append(len(all_out))
    if all_out:
        arr = np.asarray(all_out, np.float32)
    else:
        # the reference emits a [1, 1] tensor holding -1 when nothing is
        # kept
        arr = np.full((1, 1), -1.0, np.float32)
        lod = [0, 1]
    _set_lod_output(ctx, scope, op.output('Out')[0], arr, lod)


def _average_precision(tp, fp, num_gt, ap_type):
    """AP from tp/fp flags sorted by score (reference detection_map_op.h)."""
    if num_gt == 0 or len(tp) == 0:
        return None
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
    recall = tp_cum / num_gt
    if ap_type == '11point':
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return ap
    ap = 0.0  # integral
    prev_recall = 0.0
    for p, r in zip(precision, recall):
        ap += p * (r - prev_recall)
        prev_recall = r
    return ap


def _rows_per_image(ctx, op, slot, arr):
    """A host array split into per-image rows by its LoD side-band (a
    padded [B, K, D] batch by its ``@SEQLEN``; a 2-D array without one is
    one image)."""
    names = op.input(slot)
    lens = ctx.env.get(names[0] + SEQLEN_SUFFIX) if names else None
    if arr.ndim == 3:
        if lens is None:
            lens = [arr.shape[1]] * arr.shape[0]
        return [arr[i, :int(l)] for i, l in enumerate(np.asarray(lens))]
    if lens is None:
        return [arr]
    out, ofs = [], 0
    for l in np.asarray(lens).astype(int):
        out.append(arr[ofs:ofs + l])
        ofs += l
    return out


def _match_detections(det_rows, gt_rows, background_label,
                      overlap_threshold, evaluate_difficult):
    """One image's detections, by label and score, matched greedily to its
    ground truth (reference detection_map_op.h): {label: [(score, tp,
    fp)]}; a detection matched to a difficult box is neither, unless
    ``evaluate_difficult``."""
    scored = {}
    by_label = {}
    for row in gt_rows:
        by_label.setdefault(int(row[0]), []).append(row)
    for label in sorted(set(int(r[0]) for r in det_rows)):
        if label == background_label:
            continue
        rows = sorted((r for r in det_rows if int(r[0]) == label),
                      key=lambda r: -r[1])
        gts = by_label.get(label, [])
        used = [False] * len(gts)
        entry = scored.setdefault(label, [])
        for r in rows:
            best_iou, best_j = 0.0, -1
            for j, grow in enumerate(gts):
                gb = grow[1:5]
                iw = min(r[4], gb[2]) - max(r[2], gb[0])
                ih = min(r[5], gb[3]) - max(r[3], gb[1])
                inter = max(iw, 0) * max(ih, 0)
                area_d = max(r[4] - r[2], 0) * max(r[5] - r[3], 0)
                area_g = max(gb[2] - gb[0], 0) * max(gb[3] - gb[1], 0)
                union = area_d + area_g - inter
                iou = inter / union if union > 0 else 0.0
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_iou <= overlap_threshold:
                entry.append((float(r[1]), 0, 1))
                continue
            difficult = gts[best_j][5] if gts[best_j].shape[0] >= 6 else 0.0
            if not evaluate_difficult and difficult:
                continue
            entry.append((float(r[1]), 0, 1) if used[best_j] else
                         (float(r[1]), 1, 0))
            used[best_j] = True
    return scored


@register_host_op('detection_map')
def _detection_map(ctx, op, scope):
    """mAP (reference detection_map_op.cc, CPU only).  DetectRes: LoD
    [Nd, 6] rows [label, score, x1, y1, x2, y2]; Label: LoD [Ng, 6] rows
    [label, x1, y1, x2, y2, difficult], or [Ng, 5] without difficult.

    With the Accum* outputs declared, the per-class ground-truth counts and
    the scored tp / fp entries are merged with the state those scope vars
    hold when HasState is set (the reference's PosCount / TruePos /
    FalsePos), written back, and the mAP is that of the merged state."""
    det = np.asarray(ctx.get(op, 'DetectRes'))
    gt = np.asarray(ctx.get(op, 'Label'))
    a = op.attrs
    overlap_threshold = float(a.get('overlap_threshold', 0.5))
    evaluate_difficult = a.get('evaluate_difficult', True)
    background_label = int(a.get('background_label', -1))
    if det.ndim < 2 or det.shape[-1] < 6:
        det_per_img = []  # multiclass_nms's empty result: [1, 1] of -1
    else:
        det_per_img = _rows_per_image(ctx, op, 'DetectRes', det)
    gt_per_img = _rows_per_image(ctx, op, 'Label', gt)

    num_gt = {}
    for g in gt_per_img:
        for row in g:
            label = int(row[0])
            if label == background_label:
                continue
            difficult = row[5] if row.shape[0] >= 6 else 0.0
            if evaluate_difficult or not difficult:
                num_gt[label] = num_gt.get(label, 0) + 1
    scored = {}  # label -> [(score, tp, fp)]
    for img, d in enumerate(det_per_img):
        g = gt_per_img[img] if img < len(gt_per_img) else np.zeros((0, 6))
        for label, entries in _match_detections(
                d, g, background_label, overlap_threshold,
                evaluate_difficult).items():
            scored.setdefault(label, []).extend(entries)

    # the accumulated state: AccumPosCount [C, 2] rows [label, count];
    # AccumTruePos / AccumFalsePos [N, 3] rows [label, score, flag]
    state = [(op.output(slot) or [None])[0] for slot in (
        'AccumPosCount', 'AccumTruePos', 'AccumFalsePos')]
    pos_name, tp_name, fp_name = state
    has_state = ctx.get(op, 'HasState')
    if has_state is not None and \
            int(np.asarray(has_state).flatten()[0]) > 0:
        prev = scope.find_var(pos_name) if pos_name else None
        if prev is not None and prev.value() is not None:
            for label, count in _scope_array(prev.value()).reshape(-1, 2):
                num_gt[int(label)] = num_gt.get(int(label), 0) + int(count)
        for state_name, flag_col in ((tp_name, 1), (fp_name, 2)):
            var = scope.find_var(state_name) if state_name else None
            if var is not None and var.value() is not None:
                for label, score, flag in _scope_array(
                        var.value()).reshape(-1, 3):
                    e = [float(score), 0, 0]
                    e[flag_col] = int(flag)
                    scored.setdefault(int(label), []).append(tuple(e))

    aps = []
    for label in sorted(num_gt):
        entries = sorted(scored.get(label, []), key=lambda e: -e[0])
        ap = _average_precision(
            np.asarray([e[1] for e in entries], np.float64),
            np.asarray([e[2] for e in entries], np.float64),
            num_gt.get(label, 0), a.get('ap_type', 'integral'))
        if ap is not None:
            aps.append(ap)
    val = np.asarray([float(np.mean(aps)) if aps else 0.0], np.float32)
    out_name = op.output('MAP')[0]
    scope.var(out_name).set_value(val)
    ctx.store(out_name, val)

    writes = []
    if pos_name:
        writes.append((pos_name, np.asarray(
            [[l, c] for l, c in sorted(num_gt.items())],
            np.float32).reshape(-1, 2)))
    for state_name, flag_col in ((tp_name, 1), (fp_name, 2)):
        if state_name:
            writes.append((state_name, np.asarray(
                [[label, e[0], e[flag_col]] for label in sorted(scored)
                 for e in scored[label] if e[flag_col]],
                np.float32).reshape(-1, 3)))
    for name, arr in writes:
        scope.var(name).set_value(arr)
        ctx.store(name, arr)


def _box_to_delta(ex_boxes, gt_boxes):
    """Ground-truth boxes as regression deltas from anchor (ex) boxes
    (reference bbox_util.h:23 BoxToDelta, normalized=false: the +1 pixel
    width convention, no weights)."""
    ex_w = ex_boxes[:, 2] - ex_boxes[:, 0] + 1.0
    ex_h = ex_boxes[:, 3] - ex_boxes[:, 1] + 1.0
    ex_cx = ex_boxes[:, 0] + 0.5 * ex_w
    ex_cy = ex_boxes[:, 1] + 0.5 * ex_h
    gt_w = gt_boxes[:, 2] - gt_boxes[:, 0] + 1.0
    gt_h = gt_boxes[:, 3] - gt_boxes[:, 1] + 1.0
    gt_cx = gt_boxes[:, 0] + 0.5 * gt_w
    gt_cy = gt_boxes[:, 1] + 0.5 * gt_h
    return np.stack([(gt_cx - ex_cx) / ex_w, (gt_cy - ex_cy) / ex_h,
                     np.log(gt_w / ex_w), np.log(gt_h / ex_h)],
                    axis=1).astype(np.float32)


@register_host_op('rpn_target_assign')
def _rpn_target_assign(ctx, op, scope):
    """Sample anchors for RPN training (reference rpn_target_assign_op.cc,
    a CPU kernel with random subsampling).  As in the JAX package, the
    indices are flat arrays: a padded [B, G, A] IoU matrix (LoD ground
    truth) gives image b's anchors offset by b * A, as the reference
    flattens its per-image index lists."""
    iou = np.asarray(ctx.get(op, 'DistMat'))
    lens = ctx.env.get(op.input('DistMat')[0] + SEQLEN_SUFFIX)
    a = op.attrs
    rpn_batch_size = int(a.get('rpn_batch_size_per_im', 256))
    fg_fraction = float(a.get('rpn_fg_fraction', 0.25))
    pos_thr = float(a.get('rpn_positive_overlap', 0.7))
    neg_thr = float(a.get('rpn_negative_overlap', 0.3))
    rng = np.random.RandomState(int(a.get('seed', 0))
                                if a.get('fix_seed', False) else None)
    if iou.ndim == 2:
        iou = iou[None]
    if lens is None:
        lens = [iou.shape[1]] * iou.shape[0]

    def sample_one(iou_i):
        num_a = iou_i.shape[1]
        anchor_best = iou_i.max(axis=0) if iou_i.size else np.zeros((num_a, ))
        anchor_argbest = iou_i.argmax(axis=0) if iou_i.size else np.zeros(
            (num_a, ), np.int64)
        fg = set(np.where(anchor_best >= pos_thr)[0].tolist())
        # each ground-truth box's best anchor is positive whatever its IoU
        if iou_i.size:
            fg.update(iou_i.argmax(axis=1).tolist())
        fg = np.asarray(sorted(fg), np.int64)
        num_fg = min(int(rpn_batch_size * fg_fraction), fg.size)
        if fg.size > num_fg:
            fg = rng.choice(fg, size=num_fg, replace=False)
        bg_cand = np.setdiff1d(np.where(anchor_best < neg_thr)[0], fg)
        num_bg = min(rpn_batch_size - num_fg, bg_cand.size)
        bg = rng.choice(bg_cand, size=num_bg,
                        replace=False) if bg_cand.size > num_bg else bg_cand
        return fg, bg, anchor_argbest

    anchor_boxes = None
    if op.input('Anchor'):
        anchor_boxes = np.asarray(ctx.get(op, 'Anchor'),
                                  np.float32).reshape(-1, 4)
    gt_rows = None
    if op.input('GtBox'):
        # each image's rows, as the reference slices gt_bbox by its LoD
        # (rpn_target_assign_op.cc:115)
        gt_rows = _rows_per_image(ctx, op, 'GtBox', np.asarray(
            ctx.get(op, 'GtBox'), np.float32))
    deltas = anchor_boxes is not None and gt_rows is not None

    num_anchors = iou.shape[2]
    loc_parts, score_parts, lbl_parts, bbox_parts = [], [], [], []
    for b in range(iou.shape[0]):
        fg, bg, anchor_argbest = sample_one(iou[b, :int(lens[b])])
        loc_i = np.sort(fg).astype(np.int64)
        score_i = np.sort(np.concatenate([fg, bg])).astype(np.int64)
        lbl_parts.append(np.isin(score_i, fg).astype(np.int64))
        if deltas:
            # the fg anchors' BoxToDelta targets against their matched
            # ground truth (rpn_target_assign_op.cc:128-141)
            bbox_parts.append(_box_to_delta(
                anchor_boxes[loc_i], gt_rows[b][anchor_argbest[loc_i]]))
        else:
            bbox_parts.append(
                anchor_argbest[loc_i].astype(np.float32).reshape(-1, 1))
        loc_parts.append(loc_i + b * num_anchors)
        score_parts.append(score_i + b * num_anchors)
    empty = np.zeros((0, ), np.int64)
    bbox_w = 4 if deltas else 1
    outs = {
        'LocationIndex': np.concatenate(loc_parts) if loc_parts else empty,
        'ScoreIndex': np.concatenate(score_parts) if score_parts else empty,
        'TargetLabel': (np.concatenate(lbl_parts) if lbl_parts
                        else empty).reshape(-1, 1),
        'TargetBBox': (np.concatenate(bbox_parts) if bbox_parts
                       else np.zeros((0, bbox_w), np.float32)).reshape(
                           -1, bbox_w).astype(np.float32)}
    for slot, val in outs.items():
        names = op.output(slot)
        if names:
            scope.var(names[0]).set_value(val)
            ctx.store(names[0], val)


def _decode_proposals(anchors, deltas, variances):
    """RPN box decoding in pixels (reference generate_proposals_op.cc
    BoxCoder): widths with the +1 convention, dw and dh capped at
    log(1000 / 16)."""
    w = anchors[:, 2] - anchors[:, 0] + 1.0
    h = anchors[:, 3] - anchors[:, 1] + 1.0
    cx = anchors[:, 0] + 0.5 * w
    cy = anchors[:, 1] + 0.5 * h
    if variances is None:
        variances = np.ones_like(deltas)
    dx, dy, dw, dh = (deltas[:, k] * variances[:, k] for k in range(4))
    cap = np.log(1000.0 / 16.0)
    dw = np.minimum(dw, cap)
    dh = np.minimum(dh, cap)
    ncx = dx * w + cx
    ncy = dy * h + cy
    nw = np.exp(dw) * w
    nh = np.exp(dh) * h
    return np.stack([ncx - 0.5 * nw, ncy - 0.5 * nh,
                     ncx + 0.5 * nw - 1.0, ncy + 0.5 * nh - 1.0], axis=1)


@register_host_op('generate_proposals')
def _generate_proposals(ctx, op, scope):
    """RPN proposals (reference generate_proposals_op.cc, a CPU kernel):
    per image, the top pre_nms_topN anchors by score, decoded, clipped,
    filtered by size, NMS, the first post_nms_topN kept.  Outputs RpnRois
    LoD [sum, 4] and RpnRoiProbs."""
    scores = np.asarray(ctx.get(op, 'Scores'))  # [N, A, H, W]
    deltas = np.asarray(ctx.get(op, 'BboxDeltas'))  # [N, 4A, H, W]
    im_info = np.asarray(ctx.get(op, 'ImInfo'))  # [N, 3]
    anchors = np.asarray(ctx.get(op, 'Anchors')).reshape(-1, 4)
    variances = ctx.get(op, 'Variances')
    if variances is not None:
        variances = np.asarray(variances).reshape(-1, 4)
    a = op.attrs
    pre_n = int(a.get('pre_nms_topN', 6000))
    post_n = int(a.get('post_nms_topN', 1000))
    nms_thresh = float(a.get('nms_thresh', 0.5))
    min_size = float(a.get('min_size', 0.1))
    all_rois, all_probs, lod = [], [], [0]
    n, num_a, fh, fw = scores.shape
    for i in range(n):
        # [A, H, W] -> [H, W, A], the anchors' [H, W, A, 4] order
        sc = scores[i].transpose(1, 2, 0).reshape(-1)
        dl = deltas[i].reshape(num_a, 4, fh, fw).transpose(
            2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-sc, kind='stable')[:pre_n]
        props = _decode_proposals(
            anchors[order], dl[order],
            variances[order] if variances is not None else None)
        imh, imw = im_info[i, 0], im_info[i, 1]
        props[:, 0] = np.clip(props[:, 0], 0, imw - 1)
        props[:, 1] = np.clip(props[:, 1], 0, imh - 1)
        props[:, 2] = np.clip(props[:, 2], 0, imw - 1)
        props[:, 3] = np.clip(props[:, 3], 0, imh - 1)
        # FilterBoxes (generate_proposals_op.cc:155-175): min_size is in
        # the original image's units, so it scales by im_scale, and the
        # box's centre must lie inside the image
        ms = min_size * float(im_info[i, 2])
        ws = props[:, 2] - props[:, 0] + 1
        hs = props[:, 3] - props[:, 1] + 1
        xc = props[:, 0] + ws / 2
        yc = props[:, 1] + hs / 2
        keep = (ws >= ms) & (hs >= ms) & (xc <= imw) & (yc <= imh)
        props, probs = props[keep], sc[order][keep]
        kept = _nms_one_class(props, probs, -np.inf, -1, nms_thresh,
                              float(a.get('eta', 1.0)))[:post_n]
        all_rois.append(props[kept])
        all_probs.append(probs[kept].reshape(-1, 1))
        lod.append(lod[-1] + len(kept))
    rois = (np.concatenate(all_rois) if all_rois
            else np.zeros((0, 4), np.float32)).astype(np.float32)
    probs = (np.concatenate(all_probs) if all_probs
             else np.zeros((0, 1), np.float32)).astype(np.float32)
    for slot, arr in (('RpnRois', rois), ('RpnRoiProbs', probs)):
        names = op.output(slot)
        if names:
            _set_lod_output(ctx, scope, names[0], arr, lod)


def _sample_rois_one_image(rois, gt_boxes, gt_classes, is_crowd, im_scale,
                           rng, batch_size_per_im, fg_fraction, fg_thresh,
                           bg_hi, bg_lo, class_nums, weights):
    """One image's RoI sampling (reference generate_proposal_labels_op.cc
    SampleRoisForOneImage): the proposals back in the original image's
    coordinates, crowd boxes dropped, each labelled by IoU, fg and bg
    sampled, and per-class regression targets built."""
    rois = rois.reshape(-1, 4) / max(float(im_scale), 1e-6)
    not_crowd = (is_crowd.reshape(-1) == 0 if is_crowd is not None and
                 is_crowd.size else np.ones(len(gt_boxes), bool))
    gt_boxes = gt_boxes[not_crowd]
    gt_classes = gt_classes[not_crowd]
    rois2 = np.concatenate([rois, gt_boxes]) if gt_boxes.size else rois
    ious = np.zeros((rois2.shape[0], max(gt_boxes.shape[0], 1)))
    for j, gb in enumerate(gt_boxes):
        iw = np.minimum(rois2[:, 2], gb[2]) - np.maximum(rois2[:, 0],
                                                         gb[0]) + 1
        ih = np.minimum(rois2[:, 3], gb[3]) - np.maximum(rois2[:, 1],
                                                         gb[1]) + 1
        inter = np.maximum(iw, 0) * np.maximum(ih, 0)
        area_r = ((rois2[:, 2] - rois2[:, 0] + 1) *
                  (rois2[:, 3] - rois2[:, 1] + 1))
        area_g = (gb[2] - gb[0] + 1) * (gb[3] - gb[1] + 1)
        ious[:, j] = inter / np.maximum(area_r + area_g - inter, 1e-10)
    max_iou = ious.max(axis=1) if gt_boxes.size else np.zeros(
        rois2.shape[0])
    arg_gt = ious.argmax(axis=1) if gt_boxes.size else np.zeros(
        rois2.shape[0], np.int64)

    fg = np.where(max_iou >= fg_thresh)[0]
    bg = np.where((max_iou < bg_hi) & (max_iou >= bg_lo))[0]
    fg_num = min(int(batch_size_per_im * fg_fraction), fg.size)
    if fg.size > fg_num:
        fg = rng.choice(fg, size=fg_num, replace=False)
    bg_num = min(batch_size_per_im - fg_num, bg.size)
    if bg.size > bg_num:
        bg = rng.choice(bg, size=bg_num, replace=False)
    keep = np.concatenate([fg, bg]).astype(np.int64)

    sampled = rois2[keep].astype(np.float32)
    labels = np.zeros(keep.size, np.int32)
    labels[:fg.size] = gt_classes[arg_gt[fg]] if gt_classes.size else 1
    targets = np.zeros((keep.size, 4 * class_nums), np.float32)
    inside = np.zeros_like(targets)
    for k in range(fg.size):
        gb = gt_boxes[arg_gt[fg[k]]]
        rb = sampled[k]
        w = rb[2] - rb[0] + 1
        h = rb[3] - rb[1] + 1
        gcx = (gb[0] + gb[2]) / 2
        gcy = (gb[1] + gb[3]) / 2
        rcx = (rb[0] + rb[2]) / 2
        rcy = (rb[1] + rb[3]) / 2
        t = np.asarray([(gcx - rcx) / w / weights[0],
                        (gcy - rcy) / h / weights[1],
                        np.log((gb[2] - gb[0] + 1) / w) / weights[2],
                        np.log((gb[3] - gb[1] + 1) / h) / weights[3]],
                       np.float32)
        cls = int(labels[k])
        targets[k, 4 * cls:4 * cls + 4] = t
        inside[k, 4 * cls:4 * cls + 4] = 1.0
    return sampled, labels, targets, inside


@register_host_op('generate_proposal_labels')
def _generate_proposal_labels(ctx, op, scope):
    """Second-stage RoI sampling and box targets (reference
    generate_proposal_labels_op.cc): per image, the proposals labelled by
    IoU with the non-crowd ground truth, batch_size_per_im RoIs sampled at
    fg_fraction, per-class regression targets and weights."""
    a = op.attrs
    rng = np.random.RandomState(int(a.get('seed', 0))
                                if a.get('fix_seed', False) else None)
    crowd_in = ctx.get(op, 'IsCrowd')
    im_info = np.asarray(ctx.get(op, 'ImInfo')).reshape(-1, 3)
    rois_per = _rows_per_image(ctx, op, 'RpnRois',
                               np.asarray(ctx.get(op, 'RpnRois')))
    gt_per = _rows_per_image(ctx, op, 'GtBoxes',
                             np.asarray(ctx.get(op, 'GtBoxes')))
    cls_per = _rows_per_image(ctx, op, 'GtClasses',
                              np.asarray(ctx.get(op, 'GtClasses')))
    crowd_per = (_rows_per_image(ctx, op, 'IsCrowd', np.asarray(crowd_in))
                 if crowd_in is not None else [None] * len(rois_per))
    parts = {k: [] for k in ('Rois', 'LabelsInt32', 'BboxTargets',
                             'BboxInsideWeights', 'BboxOutsideWeights')}
    lod = [0]
    for i, img_rois in enumerate(rois_per):
        crowd = crowd_per[min(i, len(crowd_per) - 1)]
        sampled, labels, targets, inside = _sample_rois_one_image(
            img_rois, gt_per[min(i, len(gt_per) - 1)].reshape(-1, 4),
            cls_per[min(i, len(cls_per) - 1)].reshape(-1),
            np.asarray(crowd) if crowd is not None else None,
            im_info[min(i, im_info.shape[0] - 1), 2], rng,
            int(a.get('batch_size_per_im', 256)),
            float(a.get('fg_fraction', 0.25)),
            float(a.get('fg_thresh', 0.5)),
            float(a.get('bg_thresh_hi', 0.5)),
            float(a.get('bg_thresh_lo', 0.0)),
            int(a.get('class_nums', 81)),
            a.get('bbox_reg_weights', [0.1, 0.1, 0.2, 0.2]))
        parts['Rois'].append(sampled)
        parts['LabelsInt32'].append(labels.reshape(-1, 1))
        parts['BboxTargets'].append(targets)
        parts['BboxInsideWeights'].append(inside)
        parts['BboxOutsideWeights'].append(inside.copy())
        lod.append(lod[-1] + sampled.shape[0])
    for slot, arrs in parts.items():
        names = op.output(slot)
        if names:
            _set_lod_output(ctx, scope, names[0], np.concatenate(arrs) if arrs
                            else np.zeros((0, 4), np.float32), lod)
