"""Error clip and gradient clipping hooks (the port's counterpart of
paddle_tpu/clip.py; reference python/paddle/fluid/clip.py:32-215).

`minimize` calls `append_gradient_clip_ops` and passes
`error_clip_callback` to append_backward, as in the JAX package. Only the
no-clip path is ported: clipping by value, norm and global norm needs the
`clip`, `clip_by_norm` and `sqrt` layers and waits for a later slice.
"""

from __future__ import annotations

__all__ = ["append_gradient_clip_ops", "error_clip_callback"]


def error_clip_callback(block, op):
    """The per-op error clipping hook minimize passes to append_backward
    (reference clip.py:66); no layer of the port sets an error clip."""


def append_gradient_clip_ops(param_grad):
    """The (param, grad) pairs unchanged; a parameter that asks for a clip
    raises rather than train unclipped."""
    for p, _ in param_grad:
        if getattr(p, "gradient_clip_attr", None) is not None:
            raise NotImplementedError(
                f"parameter {p.name} asks for gradient clipping, which the "
                f"port does not have yet")
    return list(param_grad)
