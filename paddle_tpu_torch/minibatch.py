"""Minibatching, the port's copy of paddle_tpu/minibatch.py (reference:
python/paddle/v2/minibatch.py batch)."""

from __future__ import annotations

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    """Group a sample reader into a batch reader: lists of `batch_size`
    samples, the short last one kept unless `drop_last`."""

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
