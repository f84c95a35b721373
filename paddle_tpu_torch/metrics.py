"""Stateful Python-side metric aggregation, the port's copy of
paddle_tpu/metrics.py (reference: python/paddle/fluid/evaluator.py +
metrics). Accumulates numpy values across minibatches; the graph-side
per-batch values come from the chunk_eval and edit_distance layers.
Accuracy, CompositeMetric and DetectionMAP wait for 8c."""

from __future__ import annotations

import numpy as np

__all__ = ["ChunkEvaluator", "EditDistance"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


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
