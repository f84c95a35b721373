"""Reader decorators, the port's copy of paddle_tpu/reader/__init__.py
(reference: python/paddle/v2/reader/decorator.py:29-337 map_readers,
shuffle, chain, compose, buffered, firstn, xmap_readers).

A reader is a zero-argument callable that returns an iterable of samples.
A decorator wraps readers into a new reader: the host side of the input
pipeline that feeds `pipeline.DoubleBufferedFeeder`. `shuffle` draws from
Python's global `random`, as the reference's does, so a caller that wants
one order from both packages seeds it before each."""

from __future__ import annotations

import itertools
import queue
import random
import threading

from . import creator  # noqa: E402  (reference v2/reader/creator.py)

__all__ = [
    "map_readers", "buffered", "compose", "chain", "shuffle", "firstn",
    "xmap_readers", "ComposeNotAligned", "creator",
]


class ComposeNotAligned(ValueError):
    pass


def map_readers(func, *readers):
    """Apply func to the items of each reader, zipped (reference :29)."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    """Shuffle within a sliding buffer of `buf_size` samples (reference
    :59)."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers (reference :90)."""

    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers, check_alignment=True):
    """Zip readers into tuple samples (reference :121); raise
    ComposeNotAligned when they end at different lengths, unless
    check_alignment is off, which drops the unaligned tail."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum((make_tuple(o) for o in outputs), ())
        else:
            for outputs in zip(*rs):
                yield sum((make_tuple(o) for o in outputs), ())

    return reader


def buffered(reader, size):
    """Prefetch up to `size` samples on a worker thread (reference :165);
    an error of the reader is raised in the consumer."""

    class _End:
        pass

    def data_reader():
        r = reader()
        q: queue.Queue = queue.Queue(maxsize=size)
        err = []

        def fill():
            try:
                for d in r:
                    q.put(d)
            except Exception as e:  # noqa: BLE001 - raised in the consumer
                err.append(e)
            finally:
                q.put(_End)

        t = threading.Thread(target=fill, daemon=True,
                             name="pd-reader-buffered")
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e
        if err:
            raise err[0]

    return data_reader


def firstn(reader, n):
    """The first n samples (reference :213)."""

    def data_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return data_reader


class _XmapError:
    """A mapper's or the source's exception, carried to the consumer."""

    def __init__(self, exc):
        self.exc = exc


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Map `mapper` over the samples on `process_num` worker threads
    (reference :237), in the source's order when `order`. An exception of
    the mapper or of the source is raised in the consumer. Every queue
    operation gives up once the consumer is gone, so closing or abandoning
    the returned reader ends the feeder and the workers: no thread outlives
    its reader. (The JAX package schedules the same bodies on its own
    ThreadPool; plain daemon threads do the same here.)"""

    end = object()

    def data_reader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)
        abort = threading.Event()

        def _put(q, item):
            while not abort.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def _get(q):
            while not abort.is_set():
                try:
                    return q.get(timeout=0.1)
                except queue.Empty:
                    continue
            return end

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    if not _put(in_q, (i, sample)):
                        return
            except Exception as e:  # noqa: BLE001 - raised in the consumer
                _put(out_q, (-1, _XmapError(e)))
                return
            for _ in range(process_num):
                if not _put(in_q, end):
                    return

        def work():
            while True:
                item = _get(in_q)
                if item is end:
                    _put(out_q, end)
                    return
                i, sample = item
                try:
                    mapped = mapper(sample)
                except Exception as e:  # noqa: BLE001 - raised in the consumer
                    _put(out_q, (i, _XmapError(e)))
                    _put(out_q, end)
                    return
                if not _put(out_q, (i, mapped)):
                    return

        threads = [threading.Thread(target=feed, daemon=True,
                                    name="pd-xmap-feed")]
        threads += [threading.Thread(target=work, daemon=True,
                                     name=f"pd-xmap-{k}")
                    for k in range(process_num)]
        for t in threads:
            t.start()

        def _unwrap(mapped):
            if isinstance(mapped, _XmapError):
                raise mapped.exc
            return mapped

        finished = 0
        try:
            if order:
                pending = {}
                want = 0
                while finished < process_num:
                    item = out_q.get()
                    if item is end:
                        finished += 1
                        continue
                    i, mapped = item
                    pending[i] = _unwrap(mapped)
                    while want in pending:
                        yield pending.pop(want)
                        want += 1
                for i in sorted(pending):
                    yield pending[i]
            else:
                while finished < process_num:
                    item = out_q.get()
                    if item is end:
                        finished += 1
                        continue
                    yield _unwrap(item[1])
        finally:
            # exhausted, failed or abandoned: stop the feeder and workers
            abort.set()
            for t in threads:
                t.join(timeout=5)

    return data_reader
