"""DataFeeder: minibatch rows -> a feed dict of arrays (the port's
counterpart of paddle_tpu/data_feeder.py; reference
python/paddle/fluid/data_feeder.py:25 DataToLoDTensorConverter, :69
DataFeeder).

Dense slots only: the port has no LoDTensor yet, so a feed variable with
lod_level > 0 raises NotImplementedError (sequence feeds are ROADMAP
slice 8). The JAX package's telemetry becomes plain counters
(`COUNTERS`), as in the port's other modules.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

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


class DataFeeder:
    """Converts a minibatch (a list of samples, each a tuple with one entry
    per feed variable) into {name: array} for Executor.run, and K
    minibatches into {name: [K, batch, ...]} for Executor.run_steps."""

    def __init__(self, feed_list: Sequence, place, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        program = program or default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list entries must be Variables or names")
            if each_var.lod_level > 0:
                raise NotImplementedError(
                    f"feed '{each_var.name}' has lod_level "
                    f"{each_var.lod_level}: sequence (LoD) feeds come with "
                    f"the port's LoD slice (ROADMAP Queue 1, slice 8)")
            self.feed_dtypes.append(each_var.dtype)
            self.feed_names.append(each_var.name)
            shape = list(each_var.shape or [])
            if shape and shape[0] == -1:
                shape = shape[1:]
            self.feed_shapes.append(shape)
        self.place = place

    def feed(self, iterable):
        """{name: [batch, ...] array} from one minibatch."""
        t0 = time.perf_counter()
        converters = [_DenseConverter(shape, dtype) for shape, dtype in
                      zip(self.feed_shapes, self.feed_dtypes)]
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
        [K, batch, ...] array: the window Executor.run_steps runs."""
        dicts = [self.feed(mb) for mb in minibatches]
        if not dicts:
            raise ValueError("feed_window needs at least one minibatch")
        return {name: np.stack([d[name] for d in dicts])
                for name in self.feed_names}
