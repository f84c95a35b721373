"""DataFeeder: minibatch rows -> a feed dict of arrays (the port's
counterpart of paddle_tpu/data_feeder.py; reference
python/paddle/fluid/data_feeder.py:25 DataToLoDTensorConverter, :69
DataFeeder).

A slot with lod_level > 0 becomes a LoDTensor of the packed leaves and
the LoD offsets, nested levels included (`_LoDConverter`), which the
executor pads on the host (executor.pack_to_padded). The JAX package's
telemetry becomes plain counters (`COUNTERS`), as in the port's other
modules.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from .executor import LoDTensor
from .framework.framework import Variable, default_main_program

__all__ = ["DataFeeder", "COUNTERS"]


@dataclass
class Counters:
    """`batches`: minibatches `feed` converted; `seconds`: host seconds
    spent converting them (the JAX package's
    feed_conversion_seconds_total)."""
    batches: int = 0
    seconds: float = 0.0

    def reset(self):
        self.batches, self.seconds = 0, 0.0


COUNTERS = Counters()


class _DenseConverter:
    """One slot's samples -> one [batch, ...] array (reference
    DataToLoDTensorConverter at lod_level 0)."""

    def __init__(self, shape, dtype):
        self.shape = list(shape)
        self.dtype = dtype
        self.data: List = []

    def feed(self, data):
        self.data.append(data)

    def done(self):
        arr = np.array(self.data, dtype=self.dtype)
        # a flat sample fed to a shaped slot takes the slot's shape, as in
        # the reference (DataFeeder reshapes [3*224*224] to [3, 224, 224])
        want = [len(self.data)] + [d for d in self.shape if d > 0]
        if list(arr.shape) != want and arr.size == int(np.prod(want)):
            arr = arr.reshape(want)
        return arr


class _LoDConverter:
    """One sequence slot's samples -> a LoDTensor (reference
    DataToLoDTensorConverter at lod_level > 0; JAX data_feeder.py:15):
    level i of each sample adds its length to lod[i] as a running offset,
    and the leaves land flat, one row each."""

    def __init__(self, lod_level, dtype):
        self.dtype = dtype
        self.data: List = []
        self.lod = [[0] for _ in range(lod_level)]

    def feed(self, data):
        frontier = [data]
        for offsets in self.lod:
            for seq in frontier:
                offsets.append(offsets[-1] + len(seq))
            frontier = [item for seq in frontier for item in seq]
        self.data.extend(frontier)

    def done(self):
        flat = np.array(self.data, dtype=self.dtype)
        if flat.ndim == 1:
            flat = flat.reshape(-1, 1)
        return LoDTensor(flat, self.lod)


class DataFeeder:
    """Converts a minibatch (a list of samples, each a tuple with one entry
    per feed variable) into {name: array or LoDTensor} for Executor.run,
    and K minibatches of dense slots into {name: [K, batch, ...]} for
    Executor.run_steps."""

    def __init__(self, feed_list: Sequence, place, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        program = program or default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list entries must be Variables or names")
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_dtypes.append(each_var.dtype)
            self.feed_names.append(each_var.name)
            shape = list(each_var.shape or [])
            if shape and shape[0] == -1:
                shape = shape[1:]
            self.feed_shapes.append(shape)
        self.place = place

    def feed(self, iterable):
        """{name: [batch, ...] array, or a LoDTensor for a sequence slot}
        from one minibatch."""
        t0 = time.perf_counter()
        converters = [_LoDConverter(lod, dtype) if lod > 0 else
                      _DenseConverter(shape, dtype) for shape, dtype, lod in
                      zip(self.feed_shapes, self.feed_dtypes,
                          self.feed_lod_level)]
        for each_sample in iterable:
            if len(each_sample) != len(converters):
                raise ValueError(f"sample has {len(each_sample)} fields, "
                                 f"expected {len(converters)}")
            for each_converter, each_slot in zip(converters, each_sample):
                each_converter.feed(each_slot)
        ret = {name: c.done() for name, c in zip(self.feed_names, converters)}
        COUNTERS.batches += 1
        COUNTERS.seconds += time.perf_counter() - t0
        return ret

    def feed_window(self, minibatches):
        """Convert K minibatches and stack each feed name into one
        [K, batch, ...] array: the window Executor.run_steps runs. Dense
        slots only: each batch of a sequence slot pads to its own length,
        so feed those as a list of per-step dicts (`feed` each), which
        run_steps runs one step at a time."""
        dicts = [self.feed(mb) for mb in minibatches]
        if not dicts:
            raise ValueError("feed_window needs at least one minibatch")
        window = {}
        for name in self.feed_names:
            vals = [d[name] for d in dicts]
            if any(isinstance(v, LoDTensor) and v.lod for v in vals):
                raise ValueError(
                    f"feed '{name}' carries LoD; window stacking requires "
                    f"dense batches (use per-step feeds instead)")
            window[name] = np.stack(vals)
        return window
