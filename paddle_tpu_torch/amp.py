"""Automatic mixed precision (bf16 compute, fp32 master weights): the port's
counterpart of paddle_tpu/amp.py.

  * matmul/conv operands are cast to bf16 at the op (ops/common.py
    mxu_cast), accumulating in fp32;
  * parameters, batch-norm statistics and losses stay float32;
  * level O3 adds int8 (or fp8 e4m3) compute for the eligible `mul`,
    `matmul` and `conv2d` ops (quant.py), in training and in serving
    (`ServingEngine(quantize="int8" | "fp8")`).

Usage:
    amp.enable(program, level="O2")
    amp.decorate(optimizer, level="O3").minimize(loss)

Under O3 the quant mode comes from PADDLE_TPU_QUANT_MODE ("int8" by
default, "fp8" to switch), read when `enable` runs; PADDLE_TPU_QUANT=0
turns the quantized routing off (O3 then runs bitwise as O2).
"""

from __future__ import annotations

import os
from typing import Optional

from .framework.framework import Program, default_main_program

__all__ = ["enable", "disable", "decorate"]


def enable(program: Optional[Program] = None, dtype: str = "bfloat16",
           level: str = "O1"):
    """Tag `program` (default: the default main program) so matmul/conv
    ops compute in `dtype`.

    level="O1": matmul/conv compute in bf16, outputs restored to f32.
    level="O2": activations stay bf16 end to end; norm statistics and
    master weights stay f32.
    level="O3": O2 plus quantized compute where the quant gates pass, in
    the mode PADDLE_TPU_QUANT_MODE names ("int8" by default; amp.py:47-53).
    Program.clone does not carry the quant mode, as in the JAX package: a
    clone of an O3 program runs as O2.
    """
    if level not in ("O1", "O2", "O3"):
        raise ValueError(f"unknown AMP level {level!r}")
    program = program or default_main_program()
    program._amp_dtype = dtype
    program._amp_level = level
    program._quant_mode = (os.environ.get("PADDLE_TPU_QUANT_MODE", "int8")
                           if level == "O3" else None)
    return program


def disable(program: Optional[Program] = None):
    program = program or default_main_program()
    program._amp_dtype = None
    program._quant_mode = None
    return program


class _DecoratedOptimizer:
    """`minimize()` enables the bf16 policy on the program it builds into,
    then minimizes (amp.py:64; later Paddle's
    `fluid.contrib.mixed_precision.decorate(optimizer)`)."""

    def __init__(self, optimizer, dtype: str = "bfloat16",
                 level: str = "O1"):
        self._opt = optimizer
        self._dtype = dtype
        self._level = level

    def minimize(self, loss, startup_program=None, **kw):
        enable(loss.block.program, self._dtype, self._level)
        return self._opt.minimize(loss, startup_program=startup_program, **kw)

    def __getattr__(self, name):
        return getattr(self._opt, name)


def decorate(optimizer, dtype: str = "bfloat16", level: str = "O1"):
    return _DecoratedOptimizer(optimizer, dtype, level)
