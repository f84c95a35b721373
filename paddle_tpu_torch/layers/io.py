"""Data-input layers: feed declarations and the in-program file readers
(reference: python/paddle/fluid/layers/io.py:29 data, :261
open_recordio_file, :290 read_file, :334 shuffle, :347 double_buffer). The
port's counterpart of paddle_tpu/layers/io.py.

As in the JAX package, the reference's reader ops (a ReaderHolder variable
chained through decorated-reader ops, framework/reader.h:28-68) become a
host-side pipeline bound to the program: `read_file` declares the data
variables and registers the chain, and `Executor.run` with no feed for
those variables pulls the next batch from it (`while True: exe.run()`
until EOFException, then `reader.reset()`). `double_buffer` stages each
batch on the card ahead of use through reader.pipeline's
DoubleBufferedFeeder: the copy of batch N+1 runs on a copy stream while
batch N computes.
"""

from __future__ import annotations

import random

import numpy as np

from ..framework.desc import VarType
from ..framework.framework import default_main_program

__all__ = ["data", "open_recordio_file", "read_file", "shuffle", "batch",
           "multi_pass", "double_buffer", "EOFException", "FileReader"]


class EOFException(Exception):
    """Raised by Executor.run when a program-bound reader is exhausted
    (reference: fluid.core.EOFException from the reader ops)."""


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=VarType.LOD_TENSOR, stop_gradient=True):
    """Declare a feed variable (reference io.py:29). With append_batch_size,
    a -1 batch dim is prepended; the executor binds actual shapes at run."""
    block = default_main_program().current_block()
    shape = list(shape)
    if lod_level and lod_level > 0:
        # padded-LoD convention of the JAX package: one -1 time dim per level
        shape = [-1] * lod_level + shape
    if append_batch_size:
        shape = [-1] + shape
    var = block.create_var(name=name, shape=shape, dtype=dtype, type=type,
                           lod_level=lod_level, stop_gradient=stop_gradient)
    var.desc.stop_gradient = stop_gradient
    return var


class FileReader:
    """A reader chain bound to a program (the ReaderHolder's counterpart,
    reference framework/reader.h:28): `source` is a callable giving an
    iterable of sample tuples; the decorators rebind it; `read_file`
    attaches the finished chain to the program."""

    def __init__(self, source, dtypes, shapes=None, lod_levels=None):
        self.source = source
        self.dtypes = list(dtypes)
        self.shapes = list(shapes) if shapes else None
        self.lod_levels = list(lod_levels or [0] * len(self.dtypes))
        self.batched = False
        self.buffered = False           # double_buffer applied
        self._iter = None
        self._feeder = None

    def reset(self):
        """End the pass in flight: the next pull starts a new one. A
        double buffer's producer thread is stopped, so it does not stay
        blocked holding batches on the card."""
        if self._feeder is not None:
            self._feeder.stop()
            self._feeder = None
        self._iter = None

    def _start(self, device):
        self.reset()
        if self.buffered and not any(self.lod_levels):
            # dense slots go to the card on the feeder's copy stream; a LoD
            # slot stays on the host, where the executor pads it
            from ..reader.pipeline import DoubleBufferedFeeder
            n = len(self.dtypes)
            self._feeder = DoubleBufferedFeeder(
                self.source, to_feed=lambda t: {str(i): t[i] for i in range(n)},
                device=device)
            self._iter = (tuple(d[str(i)] for i in range(n))
                          for d in self._feeder)
        else:
            self._iter = iter(self.source())

    def next_batch(self, device=None):
        """The pass's next batch, a tuple in the order of read_file's
        variables; EOFException at the end of the pass."""
        if self._iter is None:
            self._start(device)
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = None
            raise EOFException("reader exhausted; call reader.reset()") \
                from None


def open_recordio_file(filename, shapes, lod_levels, dtypes, pass_num=1,
                       for_parallel=False):
    """A reader over a RecordIO file of pickled sample tuples (reference
    io.py:261, create_recordio_file_reader_op.cc), `pass_num` passes a
    pass of the program's reader."""
    from .. import recordio

    def source():
        for _ in range(max(pass_num, 1)):
            for sample in recordio.read_samples(filename):
                yield tuple(np.asarray(a) for a in sample)

    return FileReader(source, dtypes, shapes, lod_levels)


def shuffle(reader, buffer_size):
    """Shuffle within a buffer of `buffer_size` samples, drawn from Python's
    `random` (reference io.py:334, create_shuffle_reader_op.cc): each full
    buffer is shuffled and handed out from its end."""
    inner = reader.source

    def source():
        buf = []
        for s in inner():
            buf.append(s)
            if len(buf) >= buffer_size:
                random.shuffle(buf)
                while buf:
                    yield buf.pop()
        random.shuffle(buf)
        while buf:
            yield buf.pop()

    reader.source = source
    return reader


def batch(reader, batch_size):
    """Samples stacked into batches of `batch_size`, the last one shorter
    (reference create_batch_reader_op.cc). A slot of lod_level > 0 comes
    out as a LoDTensor of its packed rows, which the executor pads."""
    from ..executor import LoDTensor
    inner = reader.source
    lod_levels = reader.lod_levels

    def make_batch(samples):
        out = []
        for i in range(len(samples[0])):
            rows = [s[i] for s in samples]
            if lod_levels[i] and lod_levels[i] > 0:
                offs = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
                out.append(LoDTensor(np.concatenate(rows, axis=0),
                                     [offs.tolist()]))
            else:
                out.append(np.stack(rows))
        return tuple(out)

    def source():
        chunk = []
        for s in inner():
            chunk.append(s)
            if len(chunk) == batch_size:
                yield make_batch(chunk)
                chunk = []
        if chunk:
            yield make_batch(chunk)

    reader.source = source
    reader.batched = True
    return reader


def multi_pass(reader, pass_num):
    """The underlying source run `pass_num` times before EOF (reference
    create_multi_pass_reader_op.cc)."""
    inner = reader.source

    def source():
        for _ in range(pass_num):
            yield from inner()

    reader.source = source
    return reader


def double_buffer(reader, place=None, name=None):
    """Prefetch onto the executor's device (reference io.py:347,
    create_double_buffer_reader_op.cc): a producer thread stages the next
    batch while the current one computes."""
    reader.buffered = True
    return reader


def read_file(reader):
    """Bind the reader chain to the program and declare its output
    variables (reference io.py:290). Executor.run with no feed for them
    pulls the next batch."""
    if not reader.batched:
        raise ValueError("apply layers.batch(reader, N) before read_file")
    prog = default_main_program()
    block = prog.current_block()
    readers = getattr(prog, "_pipeline_readers", None)
    if readers is None:
        readers = prog._pipeline_readers = []
    out_vars = []
    for i, dtype in enumerate(reader.dtypes):
        shape = list(reader.shapes[i]) if reader.shapes else [-1]
        lod = reader.lod_levels[i]
        if lod and lod > 0:
            shape = [-1] * lod + [s for s in shape if s != -1]
        var = block.create_var(name=f"_reader_out_{len(readers)}_{i}",
                               shape=shape, dtype=dtype, lod_level=lod,
                               stop_gradient=True)
        var.desc.stop_gradient = True
        out_vars.append(var)
    readers.append((reader, [v.name for v in out_vars]))
    return out_vars if len(out_vars) > 1 else out_vars[0]
