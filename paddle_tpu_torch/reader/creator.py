"""Reader creators, the port's copy of paddle_tpu/reader/creator.py
(reference: python/paddle/v2/reader/creator.py — np_array, text_file,
recordio): factories that turn a data source into a sample reader, which
composes with the decorators (shuffle, batch, ...)."""

from __future__ import annotations

__all__ = ["np_array", "text_file", "recordio"]


def np_array(x):
    """Reader over the first axis of an ndarray (reference creator.py:22)."""
    import numpy as np

    arr = np.asarray(x)

    def reader():
        for row in arr:
            yield row

    return reader


def text_file(path):
    """Reader yielding the lines of a text file without their newline
    (reference creator.py:42)."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=100, decode=False):
    """Reader over RecordIO file(s), a comma-separated string or a list:
    the raw record bytes, as the reference's creator.py:60 yields them, or
    with decode=True the samples `recordio.write_samples` pickled.

    buf_size is accepted for the reference's signature and not applied, as
    in the JAX package: compose `reader.buffered(r, n)` for prefetch. A
    generator here closes its scanner as soon as a consumer abandons it."""
    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        from .. import recordio as recordio_mod
        for p in paths:
            if decode:
                yield from recordio_mod.read_samples(p)
            else:
                with recordio_mod.RecordIOScanner(p) as scanner:
                    yield from scanner

    return reader
