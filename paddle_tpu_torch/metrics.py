"""Stateful Python-side metric aggregation, the port's copy of
paddle_tpu/metrics.py (reference: python/paddle/fluid/evaluator.py +
metrics). Accumulates numpy values across minibatches; the graph-side
per-batch values come from layers.accuracy, chunk_eval, edit_distance and
the detection layers."""

from __future__ import annotations

import numpy as np

__all__ = ["Accuracy", "ChunkEvaluator", "EditDistance", "CompositeMetric",
           "DetectionMAP"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    """The weighted mean of per-batch accuracies."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no minibatch accumulated")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    """Chunk F1 aggregation (reference evaluator.py:111 ChunkEvaluator)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        def _sc(x):
            return int(np.asarray(x).reshape(-1)[0])
        self.num_infer_chunks += _sc(num_infer_chunks)
        self.num_label_chunks += _sc(num_label_chunks)
        self.num_correct_chunks += _sc(num_correct_chunks)

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.total_distance += float(distances.sum())
        self.seq_num += int(np.asarray(seq_num).reshape(-1)[0])
        self.instance_error += int((distances > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data accumulated")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class CompositeMetric(MetricBase):
    """Several metrics updated together, each from its own argument tuple."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, *args):
        for m, a in zip(self._metrics, args):
            m.update(*a)

    def eval(self):
        return [m.eval() for m in self._metrics]


class DetectionMAP(MetricBase):
    """Detection mAP accumulated across minibatches (reference
    evaluator.py:254 DetectionMAP) on the host: each update() merges the
    batch's per-class (score, tp/fp) pairs, and eval() is the mAP of all
    of them, by the same host arithmetic as the detection_map op
    (ops/detection_ops.py detection_tp_fp, map_from_tp_fp).

    update(dets, det_counts, gts, gt_counts): padded [B, D, 6] / [B, G, 6]
    batches and each image's valid count, as fetched."""

    def __init__(self, class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral", name=None):
        super().__init__(name)
        self.background_label = background_label
        self.overlap_threshold = overlap_threshold
        self.evaluate_difficult = evaluate_difficult
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        self._label_pos = {}
        self._tp = {}
        self._fp = {}
        self._n_updates = 0

    def update(self, dets, det_counts, gts, gt_counts):
        from .ops.detection_ops import detection_tp_fp
        lp, tp, fp = detection_tp_fp(
            np.asarray(dets, np.float32), np.asarray(det_counts, np.int64),
            np.asarray(gts, np.float32), np.asarray(gt_counts, np.int64),
            self.overlap_threshold, self.evaluate_difficult)
        for k, v in lp.items():
            self._label_pos[k] = self._label_pos.get(k, 0) + v
        for k, v in tp.items():
            self._tp.setdefault(k, []).extend(v)
        for k, v in fp.items():
            self._fp.setdefault(k, []).extend(v)
        self._n_updates += 1

    def eval(self):
        if not self._n_updates:
            raise ValueError("DetectionMAP.eval() before any update()")
        from .ops.detection_ops import map_from_tp_fp
        return float(map_from_tp_fp(
            self._label_pos, self._tp, self._fp, self.ap_version,
            self.background_label))
