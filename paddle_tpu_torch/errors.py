"""Typed errors (the port's counterpart of paddle_tpu/errors.py). Only what
serving needs so far: `ServingOverloadError`, which the batcher raises.
The rest of the reference's hierarchy comes with the slices that raise it;
the executor keeps its own `EnforceNotMet` (executor.py)."""

from __future__ import annotations

__all__ = ["ServingOverloadError"]


class ServingOverloadError(RuntimeError):
    """A serving request was rejected by overload control (serving/batcher):
    either the bounded request queue was full at submit time, or the
    request's deadline expired before its batch reached the device.
    Shedding with a typed error keeps the accepted requests' latency bounded
    instead of letting the queue collapse under 2x load — the caller is
    expected to retry against another replica or surface the rejection.

    `reason` is the shed cause ("queue_full" | "deadline" | "shutdown"),
    `queue_depth` the depth observed at rejection."""

    def __init__(self, message, reason=None, queue_depth=None):
        super().__init__(message)
        self.reason = reason
        self.queue_depth = queue_depth

    def to_dict(self):
        """JSON-serializable view."""
        return {
            "type": type(self).__name__,
            "message": str(self),
            "reason": self.reason,
            "queue_depth": self.queue_depth,
        }
