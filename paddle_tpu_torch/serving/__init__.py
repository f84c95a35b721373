"""Inference serving (the port's counterpart of paddle_tpu/serving).

  * `ServingEngine` (engine.py) — prune to the inference fetch set, one
    CUDA graph per padded batch-size bucket (powers-of-two ladder,
    LRU-evicted), weights resident on the card and read in place.
  * `DynamicBatcher` (batcher.py) — thread-safe queue coalescing
    variable-size requests into the smallest admissible bucket under a
    max-latency timer; bounded depth with deadline-aware load shedding
    (`ServingOverloadError`), per-request latency histograms.
  * harness.py — concurrent-client load generator reporting
    p50/p99/qps/bucket-hits/goodput (`run_load`, `overload_report`).
  * slo.py — per-model availability/latency objectives with fast/slow
    window burn-rate evaluation, fed one outcome per request by the
    batcher (`slo_burn_rate{model,window}`).
"""

from .engine import (ServingEngine, bucket_ladder, is_training_only_op,
                     training_only_op_types)
from .batcher import DynamicBatcher
from .harness import overload_report, run_load
from .slo import SLO, SLOMonitor, monitor_for
from ..errors import ServingOverloadError

__all__ = ["ServingEngine", "DynamicBatcher", "ServingOverloadError",
           "bucket_ladder", "is_training_only_op", "training_only_op_types",
           "overload_report", "run_load", "SLO", "SLOMonitor",
           "monitor_for"]
