"""Metric op lowerings (counterpart of ``paddle_tpu/ops/metric_ops.py``:
``accuracy``, ``auc``, ``precision_recall`` and
``positive_negative_pair``), each computed on the device.  No gradient:
``backward.append_backward`` reaches no metric op from a loss.

Under data parallelism ``accuracy``, ``auc`` and ``precision_recall`` over
rows the ranks split count over the global batch: their counts are
all-reduced before the ratios.  ``positive_negative_pair`` pairs rows with
each other and is not dp-aware."""

import torch

from .registry import register_lowering, declare_dp_aware


@register_lowering('accuracy')
def _accuracy(ctx, op):
    indices = ctx.get(op, 'Indices')  # [N, k] from top_k
    label = ctx.get(op, 'Label')  # [N, 1] int64
    if label.dim() == 1:
        label = label[:, None]
    hit = torch.any(indices == label.to(indices.dtype), dim=1)
    correct = torch.sum(hit.to(torch.int64))
    # a fill on the device, not a copy from the host: a capture holds it
    total = torch.full((), indices.shape[0], dtype=torch.int64,
                       device=indices.device)
    if ctx.dp_split(op.input('Indices')[0]):
        correct, total = ctx.global_sum(correct, total)
    ctx.set(op, 'Accuracy',
            torch.reshape(correct.to(torch.float32) / total, (1, )))
    ctx.set(op, 'Correct', torch.reshape(correct, (1, )))
    ctx.set(op, 'Total', torch.reshape(total, (1, )))


@register_lowering('auc')
def _auc(ctx, op):
    """The batch's ROC AUC over ``num_thresholds`` thresholds evenly in [0,
    1]: the [thresholds, N] comparisons counted, then the trapezoids.  The
    counts are f32, as the JAX package's are with 64-bit types off."""
    probs = ctx.get(op, 'Predict')
    if probs is None:
        probs = ctx.get(op, 'Out')
    label = torch.reshape(ctx.get(op, 'Label'), (-1, ))
    pos_prob = probs[:, -1] if probs.dim() > 1 else probs
    thresholds = torch.linspace(0.0, 1.0, op.attrs.get('num_thresholds', 200),
                                dtype=torch.float32, device=probs.device)
    pos = label > 0
    pred = pos_prob[None, :] >= thresholds[:, None]  # [T, N]

    def count(a):
        return torch.sum(a, dim=1).to(torch.float32)

    tp, fp = count(pred & pos[None, :]), count(pred & ~pos[None, :])
    fn, tn = count(~pred & pos[None, :]), count(~pred & ~pos[None, :])
    if ctx.dp_split(op.input('Label')[0]):
        tp, fp, fn, tn = ctx.global_sum(tp, fp, fn, tn)
    tpr = tp / torch.clamp_min(tp + fn, 1e-12)
    fpr = fp / torch.clamp_min(fp + tn, 1e-12)
    auc = torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)
    ctx.set(op, 'AUC', torch.reshape(torch.abs(auc), (1, )))


@register_lowering('precision_recall')
def _precision_recall(ctx, op):
    """[3]: the batch's precision, recall and F1, each averaged over the
    ``class_number`` classes."""
    indices = torch.reshape(ctx.get(op, 'Indices'), (-1, ))
    label = torch.reshape(ctx.get(op, 'Labels'), (-1, ))
    classes = torch.arange(op.attrs['class_number'], device=indices.device)
    pred = indices[:, None] == classes[None, :]
    truth = label[:, None] == classes[None, :]

    def count(a):
        return torch.sum(a, dim=0).to(torch.float32)

    tp, fp, fn = count(pred & truth), count(pred & ~truth), \
        count(~pred & truth)
    if ctx.dp_split(op.input('Labels')[0]):
        tp, fp, fn = ctx.global_sum(tp, fp, fn)
    precision = tp / torch.clamp_min(tp + fp, 1e-12)
    recall = tp / torch.clamp_min(tp + fn, 1e-12)
    f1 = 2 * precision * recall / torch.clamp_min(precision + recall, 1e-12)
    ctx.set(op, 'BatchMetrics', torch.stack(
        [torch.mean(precision), torch.mean(recall), torch.mean(f1)]))


declare_dp_aware('accuracy', 'auc', 'precision_recall')


@register_lowering('positive_negative_pair')
def _positive_negative_pair(ctx, op):
    """Over the pairs of items in one query with different labels: the
    pairs whose scores order as their labels (positive), the other way
    (negative), and tied scores (neutral), each added to its
    ``Accumulate*`` input where one is given."""
    score = torch.reshape(ctx.get(op, 'Score'), (-1, ))
    label = torch.reshape(ctx.get(op, 'Label'), (-1, ))
    qid = torch.reshape(ctx.get(op, 'QueryID'), (-1, ))
    upper = torch.triu(torch.ones((score.shape[0], score.shape[0]),
                                  dtype=torch.bool, device=score.device), 1)
    ldiff = label[:, None] - label[None, :]
    sdiff = score[:, None] - score[None, :]
    cand = (qid[:, None] == qid[None, :]) & upper & (ldiff != 0)
    agree = ldiff * sdiff
    for in_slot, out_slot, hit in (
            ('AccumulatePositivePair', 'PositivePair', agree > 0),
            ('AccumulateNegativePair', 'NegativePair', agree < 0),
            ('AccumulateNeutralPair', 'NeutralPair', sdiff == 0)):
        v = torch.sum((cand & hit).to(torch.float32))
        prev = ctx.get(op, in_slot)
        if prev is not None:
            v = v + torch.reshape(prev, ())
        ctx.set(op, out_slot, torch.reshape(v, (1, )))
