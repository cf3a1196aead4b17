"""Metric accumulators: the port's own copy of ``paddle_tpu/metrics.py``
(Fluid's python/paddle/fluid/metrics.py).

Host-side running accumulators updated from fetched batch outputs:
``update()`` with numpy arrays, ``eval()`` the aggregate, ``reset()``
clears the state.
"""

import numpy as np

__all__ = [
    "MetricBase", "CompositeMetric", "Precision", "Recall", "Accuracy",
    "ChunkEvaluator", "EditDistance", "Auc", "DetectionMAP",
]


def _to_np(x):
    return np.asarray(x)


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    def get_config(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}


class CompositeMetric(MetricBase):
    """Holds several metrics updated with the same inputs
    (metrics.py CompositeMetric)."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise ValueError("add_metric expects a MetricBase")
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    """Binary precision over {0,1} predictions (metrics.py Precision)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(_to_np(preds)).astype(np.int64).ravel()
        labels = _to_np(labels).astype(np.int64).ravel()
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(_to_np(preds)).astype(np.int64).ravel()
        labels = _to_np(labels).astype(np.int64).ravel()
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        rel = self.tp + self.fn
        return float(self.tp) / rel if rel else 0.0


class Accuracy(MetricBase):
    """Weighted running accuracy (metrics.py Accuracy): update(value,
    weight) with the batch accuracy value (e.g. from layers.accuracy)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        if weight < 0:
            raise ValueError("weight must be >= 0")
        self.value += float(np.asarray(value).ravel()[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy has no accumulated data")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    """F1 over chunk counts (metrics.py ChunkEvaluator): update with
    (num_infer_chunks, num_label_chunks, num_correct_chunks)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        def scalar(x):
            return int(np.asarray(x).ravel()[0])

        self.num_infer_chunks += scalar(num_infer_chunks)
        self.num_label_chunks += scalar(num_label_chunks)
        self.num_correct_chunks += scalar(num_correct_chunks)

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    """Average edit distance + instance error rate (metrics.py
    EditDistance): update with per-instance distances and an error count."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = _to_np(distances).ravel()
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances != 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance has no accumulated data")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class Auc(MetricBase):
    """ROC AUC via fixed thresholds histogram (metrics.py Auc)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        n = self._num_thresholds + 1
        self._stat_pos = np.zeros(n, dtype=np.int64)
        self._stat_neg = np.zeros(n, dtype=np.int64)

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels).ravel().astype(np.int64)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.ravel()
        bins = np.minimum(
            (pos_prob * self._num_thresholds).astype(np.int64),
            self._num_thresholds)
        np.add.at(self._stat_pos, bins[labels == 1], 1)
        np.add.at(self._stat_neg, bins[labels != 1], 1)

    @staticmethod
    def trapezoid_area(x1, x2, y1, y2):
        return abs(x1 - x2) * (y1 + y2) / 2.0

    def eval(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        idx = self._num_thresholds
        while idx >= 0:
            new_pos = tot_pos + self._stat_pos[idx]
            new_neg = tot_neg + self._stat_neg[idx]
            auc += self.trapezoid_area(tot_neg, new_neg, tot_pos, new_pos)
            tot_pos, tot_neg = new_pos, new_neg
            idx -= 1
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0


class DetectionMAP(MetricBase):
    """Mean average precision accumulator for detection
    (metrics.py DetectionMAP, simplified: accumulates per-batch mAP values
    computed by the detection_map op and averages them)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.has_state = False
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        self.value += float(np.asarray(value).ravel()[0]) * weight
        self.weight += weight
        self.has_state = True

    def eval(self):
        if not self.has_state:
            raise ValueError("DetectionMAP has no accumulated data")
        return self.value / self.weight
