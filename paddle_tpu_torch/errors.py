"""Typed errors (the port's counterpart of paddle_tpu/errors.py; reference:
paddle/fluid/platform/enforce.h EnforceNotMet and pybind/exception.cc's
mapping of C++ exceptions onto Python types). Each class keeps the JAX
package's fields and `to_dict()`, the JSON view a crash report carries.
The executor raises `EnforceNotMet` when an op's lowering fails, `OOMError`
when the card runs out of memory (memory.maybe_oom_error) and, under
PADDLE_TPU_VERIFY=1, `ProgramVerifyError` before a program's first step
(analysis.analyze_program); the serving engine raises `ProgramVerifyError`
at admission and the batcher `ServingOverloadError`. `NonFiniteError` is
defined here; raising it under check_nan_inf needs the inspector's
statistics and attribution, which the port does not have yet."""

from __future__ import annotations

__all__ = ["EnforceNotMet", "EOFException", "NonFiniteError", "NotFoundError",
           "OOMError", "ProgramVerifyError", "ServingOverloadError"]


class EnforceNotMet(RuntimeError):
    """An operator's runtime contract failed (reference PADDLE_ENFORCE): the
    message names the op, its variables, the live input shapes and the user
    line that built it."""

    def __init__(self, message, op_type=None, creation_site=None):
        super().__init__(message)
        self.op_type = op_type
        self.creation_site = creation_site


class NonFiniteError(FloatingPointError, RuntimeError):
    """A NaN/Inf was detected in a tensor (reference FLAGS_check_nan_inf,
    executor.cc:325 CheckTensorNANOrInf). Subclasses both FloatingPointError
    and RuntimeError, as the JAX package's does.

    `var_name`/`dtype` name the tensor the detection fired on,
    `op_type`/`op_index` the producing op when known, `stats` its tensor
    statistics and `attribution` the bisection's result (None when
    attribution is off or inconclusive)."""

    def __init__(self, message, var_name=None, dtype=None, op_type=None,
                 op_index=None, stats=None, attribution=None,
                 feed_signature=None):
        super().__init__(message)
        self.var_name = var_name
        self.dtype = dtype
        self.op_type = op_type
        self.op_index = op_index
        self.stats = stats
        self.attribution = attribution
        self.feed_signature = feed_signature

    def to_dict(self):
        """JSON-serializable view."""
        return {
            "type": type(self).__name__,
            "message": str(self),
            "var_name": self.var_name,
            "dtype": self.dtype,
            "op_type": self.op_type,
            "op_index": self.op_index,
            "stats": self.stats.to_dict() if self.stats is not None else None,
            "attribution": (self.attribution.to_dict()
                            if self.attribution is not None else None),
            "feed_signature": ([list(s) for s in self.feed_signature]
                               if self.feed_signature else None),
        }


class OOMError(MemoryError, RuntimeError):
    """The card ran out of memory. PyTorch raises torch.cuda.OutOfMemoryError
    (the caching allocator's "CUDA out of memory"), which names the failed
    allocation but nothing of what occupies the card; the executor
    (memory.maybe_oom_error) replaces it with this structured error.
    Subclasses MemoryError and RuntimeError, as the JAX package's; the
    message keeps "out of memory" for callers that match the text.

    Fields: `breakdown` maps byte classes (params/opt_state/feeds, and the
    allocator's bytes_in_use/bytes_limit/peak_bytes_in_use on a card),
    `top_buffers` lists the largest live tensors (named by their scope,
    feed or block variable), `donation_lost_bytes` is 0 in the port (state
    is updated in place), `analysis` the program's static
    memory.ProgramMemory view, and `suggestions` concrete next steps (AMP,
    the fitted HeadroomModel's max batch)."""

    def __init__(self, message, program=None, breakdown=None,
                 top_buffers=None, donation_lost_bytes=0, analysis=None,
                 suggestions=None, device=None):
        super().__init__(message)
        self.program = program
        self.breakdown = dict(breakdown or {})
        self.top_buffers = list(top_buffers or [])
        self.donation_lost_bytes = donation_lost_bytes
        self.analysis = analysis
        self.suggestions = list(suggestions or [])
        self.device = device

    def to_dict(self):
        """JSON-serializable view."""
        return {
            "type": type(self).__name__,
            "message": str(self),
            "program": self.program,
            "breakdown": self.breakdown,
            "top_buffers": self.top_buffers,
            "donation_lost_bytes": self.donation_lost_bytes,
            "analysis": self.analysis,
            "suggestions": self.suggestions,
            "device": self.device,
        }


class ProgramVerifyError(RuntimeError):
    """The static analyzer (paddle_tpu_torch.analysis) found error-severity
    diagnostics in a program about to run or be served: raised before its
    first op, so the message points at the op's creation site instead of a
    lowering's traceback.

    `diagnostics` holds the analysis.Diagnostic objects (error severity
    only); the message numbers them with op index, source site and hint."""

    def __init__(self, diagnostics, program_name=None):
        self.diagnostics = list(diagnostics)
        self.program_name = program_name
        head = (f"program verification failed: "
                f"{len(self.diagnostics)} error(s)")
        if program_name:
            head += f" in {program_name}"
        body = "\n".join(f"  [{i + 1}] {d.format()}"
                         for i, d in enumerate(self.diagnostics))
        super().__init__(head + ("\n" + body if body else "") +
                         "\n(set PADDLE_TPU_VERIFY=0 to skip verification, "
                         "or run paddle_tpu_torch.analysis.analyze_program "
                         "for the full report)")

    def to_dict(self):
        """JSON-serializable view."""
        return {
            "type": type(self).__name__,
            "message": str(self),
            "program_name": self.program_name,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }


class NotFoundError(KeyError):
    """A variable/operator lookup failed (reference NotFound error code)."""


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


def __getattr__(name):
    # EOFException lives in layers.io (it predates this module); re-exported
    # lazily so the hierarchy is one import away without an import cycle
    if name == "EOFException":
        from .layers.io import EOFException
        return EOFException
    raise AttributeError(name)
