"""Python-side metric accumulators of the PyTorch port: its own copy of
``paddle_tpu/fluid/metrics.py`` (reference:
python/paddle/fluid/metrics.py), numpy only."""

import numpy as np

__all__ = [
    'MetricBase', 'CompositeMetric', 'Precision', 'Recall', 'Accuracy',
    'ChunkEvaluator', 'EditDistance', 'DetectionMAP', 'Auc',
]


def _is_numpy_(var):
    return isinstance(var, (np.ndarray, np.generic))


class MetricBase(object):
    def __init__(self, name=None):
        self._name = str(name) if name is not None else self.__class__.__name__

    def __str__(self):
        return self._name

    def reset(self):
        states = {
            attr: value
            for attr, value in self.__dict__.items()
            if not attr.startswith('_')
        }
        for attr, value in states.items():
            if isinstance(value, int):
                setattr(self, attr, 0)
            elif isinstance(value, float):
                setattr(self, attr, .0)
            elif isinstance(value, (np.ndarray, np.generic)):
                setattr(self, attr, np.zeros_like(value))
            else:
                setattr(self, attr, None)

    def get_config(self):
        return {
            attr: value
            for attr, value in self.__dict__.items()
            if not attr.startswith('_')
        }

    def update(self, preds, labels):
        raise NotImplementedError()

    def eval(self):
        raise NotImplementedError()


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super(CompositeMetric, self).__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise ValueError('metric should be MetricBase')
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    """Binary precision (reference metrics.py Precision)."""

    def __init__(self, name=None):
        super(Precision, self).__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype('int32').flatten()
        labels = np.asarray(labels).astype('int32').flatten()
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap != 0 else .0


class Recall(MetricBase):
    def __init__(self, name=None):
        super(Recall, self).__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype('int32').flatten()
        labels = np.asarray(labels).astype('int32').flatten()
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        recall = self.tp + self.fn
        return float(self.tp) / recall if recall != 0 else .0


class Accuracy(MetricBase):
    """Weighted accuracy accumulator fed from the accuracy op's output."""

    def __init__(self, name=None):
        super(Accuracy, self).__init__(name)
        self.value = .0
        self.weight = .0

    def update(self, value, weight):
        self.value += float(np.asarray(value).flatten()[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError('Accuracy has no data; call update first')
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    """Chunk F1 from chunk_eval op outputs (reference metrics.py)."""

    def __init__(self, name=None):
        super(ChunkEvaluator, self).__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).flatten()[0])
        self.num_label_chunks += int(np.asarray(num_label_chunks).flatten()[0])
        self.num_correct_chunks += int(
            np.asarray(num_correct_chunks).flatten()[0])

    def eval(self):
        precision = float(
            self.num_correct_chunks
        ) / self.num_infer_chunks if self.num_infer_chunks else 0
        recall = float(self.num_correct_chunks
                       ) / self.num_label_chunks if self.num_label_chunks else 0
        f1_score = float(2 * precision * recall) / (
            precision + recall) if self.num_correct_chunks else 0
        return precision, recall, f1_score


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super(EditDistance, self).__init__(name)
        self.total_distance = .0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances != 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError('no data in EditDistance')
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / float(self.seq_num)
        return avg_distance, avg_instance_error


class Auc(MetricBase):
    """Streaming AUC over confusion-bins (reference metrics.py Auc)."""

    def __init__(self, name=None, curve='ROC', num_thresholds=200):
        super(Auc, self).__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self.tp_list = np.zeros((num_thresholds, ))
        self.fn_list = np.zeros((num_thresholds, ))
        self.tn_list = np.zeros((num_thresholds, ))
        self.fp_list = np.zeros((num_thresholds, ))

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).flatten()
        kepsilon = 1e-7
        thresholds = [(i + 1) * 1.0 / (self._num_thresholds - 1)
                      for i in range(self._num_thresholds - 2)]
        thresholds = [0.0 - kepsilon] + thresholds + [1.0 + kepsilon]
        pos_prob = preds[:, -1] if preds.ndim > 1 else preds
        for i, thresh in enumerate(thresholds):
            pred_pos = pos_prob >= thresh
            self.tp_list[i] += np.sum(pred_pos & (labels > 0))
            self.fp_list[i] += np.sum(pred_pos & (labels <= 0))
            self.fn_list[i] += np.sum(~pred_pos & (labels > 0))
            self.tn_list[i] += np.sum(~pred_pos & (labels <= 0))

    def eval(self):
        epsilon = 1e-6
        num_thresholds = self._num_thresholds
        tpr = (self.tp_list.astype('float64') + epsilon) / (
            self.tp_list + self.fn_list + epsilon)
        fpr = self.fp_list.astype('float64') / (
            self.fp_list + self.tn_list + epsilon)
        rec = (self.tp_list.astype('float64') + epsilon) / (
            self.tp_list + self.fp_list + epsilon)
        x = fpr[::-1] if self._curve == 'ROC' else rec[::-1]
        y = tpr[::-1]
        auc_value = 0.0
        for i in range(num_thresholds - 1):
            auc_value += (x[i + 1] - x[i]) * (y[i + 1] + y[i]) / 2.0
        return abs(auc_value)


class DetectionMAP(MetricBase):
    def __init__(self, name=None):
        super(DetectionMAP, self).__init__(name)
        self.has_state = None

    def update(self, value, weight=1):
        if not _is_numpy_(np.asarray(value)):
            raise ValueError('value must be numpy-compatible')
        self.value = np.asarray(value)
        self.weight = weight
        self.has_state = True

    def eval(self):
        if self.has_state is None:
            raise ValueError('DetectionMAP has no accumulated state')
        return float(np.asarray(self.value).flatten()[0])
