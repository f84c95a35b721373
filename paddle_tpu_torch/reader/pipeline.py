"""Device-side input pipeline: batches staged on the card ahead of use (the
port's counterpart of paddle_tpu/reader/pipeline.py; reference:
framework/reader.h:28-68 ReaderBase/DecoratedReader,
operators/reader/create_double_buffer_reader_op.cc).

What the double buffer buys is that the host-to-device copy of batch N+1
runs while batch N computes. In PyTorch's idiom: a producer thread turns
each batch into pinned host tensors and copies them with
`non_blocking=True` on the feeder's own `torch.cuda.Stream`, recording a
`torch.cuda.Event` after the copy; the consumer makes its current stream
wait on that event before it hands the batch out, and marks each tensor
as used on its stream (`record_stream`), so the caching allocator, which
made the tensor on the copy stream, does not hand its memory to a later
copy while the consumer's kernels still read it. `next_window(k)` stacks
k batches on the host into one pinned [k, ...] buffer per feed name,
reused from window to window, and copies each name once: the input half of
`Executor.run_steps`. On a CPU device the same pipeline hands out CPU
tensors and copies nothing.

Counters (`COUNTERS`) stand in for the JAX package's telemetry: batches
and windows handed out, remainder batches dropped at the end of a pass,
and the consumer's seconds waiting for the producer.

The JAX package's `sparse_slots` argument (the hot-row embedding cache's
id dedup) waits for the port's sparse slice (ROADMAP Queue 1, slice 7).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

__all__ = ["DoubleBufferedFeeder", "COUNTERS"]

_STOP = object()


@dataclass
class Counters:
    """`batches`: batches handed out one by one; `windows`: windows handed
    out by next_window; `dropped`: batches of an end-of-pass remainder
    shorter than the window; `wait_s`: seconds the consumer spent waiting
    on the feeder's queues (0 while the producer keeps ahead)."""
    batches: int = 0
    windows: int = 0
    dropped: int = 0
    wait_s: float = 0.0

    def reset(self):
        self.batches = self.windows = self.dropped = 0
        self.wait_s = 0.0


COUNTERS = Counters()


def _resolve_device(device) -> torch.device:
    """The feeder's device: the current CUDA device by default; a CUDA
    device asked for where there is none raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("DoubleBufferedFeeder stages batches on the "
                               "CUDA device by default, and torch sees none; "
                               "pass device=torch.device('cpu')")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"DoubleBufferedFeeder asked for {device}, but "
                               f"torch sees no CUDA device")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"DoubleBufferedFeeder asked for {device}, but "
                               f"torch sees {torch.cuda.device_count()} CUDA "
                               f"devices")
    return device


class _Staged:
    """A feed dict on the card and the event its copies end with."""

    def __init__(self, feed: Dict[str, torch.Tensor], event):
        self.feed = feed
        self.event = event

    def hand_out(self, device) -> Dict[str, torch.Tensor]:
        """The consumer side: its stream waits for the copies, and each
        tensor is marked as used on that stream."""
        if self.event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(self.event)
            for t in self.feed.values():
                t.record_stream(stream)
        return self.feed


class DoubleBufferedFeeder:
    """Wrap a batch reader into an iterator of device-resident feed dicts.

    reader: a callable returning an iterable of batches (the paddle reader
    convention). to_feed: batch -> {name: array} (e.g. DataFeeder.feed;
    the identity for readers of dicts). device: a torch.device, the
    current CUDA device by default; `torch.device("cpu")` hands out CPU
    tensors. capacity: the batch queue's depth (2 = double buffering, the
    reference's default). window_prefetch: how many stacked windows
    next_window builds ahead on a second thread (1: it stacks on the
    caller's thread, and only the batch producer runs ahead)."""

    def __init__(self, reader: Callable[[], Iterable], to_feed=None,
                 device=None, capacity: int = 2, window_prefetch: int = 1):
        self.reader = reader
        self.to_feed = to_feed or (lambda b: b)
        self.device = _resolve_device(device)
        self.capacity = capacity
        self.window_prefetch = max(1, int(window_prefetch))
        self._stream = None          # the copy stream, made at first use
        self._thread: Optional[threading.Thread] = None
        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        # next_window's pass: windows pull from one pass of the reader
        self._consumer = None
        # the window thread (window_prefetch > 1)
        self._wthread: Optional[threading.Thread] = None
        self._wqueue: Optional[queue.Queue] = None
        self._wstop = threading.Event()
        self._wkey = None
        # per (device, feed name): the pinned staging buffer of a window and
        # the event that ends the last copy out of it
        self._pinned: Dict[tuple, List] = {}

    # --- the batch producer -------------------------------------------------
    def _copy_stream(self, device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _stage(self, feed: Dict[str, Any], device) -> _Staged:
        """Host arrays -> pinned tensors -> device tensors copied on the
        copy stream, with the event that ends the copies."""
        arrays = {k: np.asarray(v) for k, v in feed.items()}
        if device.type != "cuda":
            return _Staged({k: torch.from_numpy(a) for k, a in
                            arrays.items()}, None)
        stream = self._copy_stream(device)
        out = {}
        with torch.cuda.device(device), torch.cuda.stream(stream):
            for k, a in arrays.items():
                host = torch.empty(a.shape, dtype=_torch_dtype(a.dtype),
                                   pin_memory=True)
                host.numpy()[...] = a
                out[k] = host.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(out, event)

    def _produce(self, q, stop, stage):
        """The producer thread: each batch converted (and, with `stage`,
        copied to the device) into the bounded queue; an error goes to the
        consumer."""
        try:
            for batch in self.reader():
                if stop.is_set():
                    return
                feed = self.to_feed(batch)
                q.put(self._stage(feed, self.device) if stage else feed)
        except Exception as e:  # noqa: BLE001 - raised in the consumer
            q.put(e)
            return
        q.put(_STOP)

    def __iter__(self):
        """One pass of the reader, each batch a feed dict on the device."""
        return self._batches(stage=True)

    def _batches(self, stage, consumer=True):
        """One pass of the producer's items: staged feeds handed out on the
        device, or with stage off the host feeds a window is stacked from.
        `consumer`: this runs on the consumer's thread, whose waits count
        in COUNTERS.wait_s (the window thread's do not)."""
        self.reset(stage)
        q, thread = self._queue, self._thread
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if consumer:
                COUNTERS.wait_s += time.perf_counter() - t0
            if item is _STOP or isinstance(item, Exception):
                thread.join()
                if self._thread is thread:
                    self._thread = None
                if item is _STOP:
                    return
                raise item
            COUNTERS.batches += 1
            yield item.hand_out(self.device) if stage else item

    # --- windows ------------------------------------------------------------
    def next_window(self, k: int, device=None) -> Dict[str, torch.Tensor]:
        """The next k batches of the pass, each feed name stacked into one
        [k, ...] tensor on `device` (the feeder's by default): the input of
        Executor.run_steps. Raises StopIteration at the end of a pass; a
        shorter remainder is dropped and counted in `COUNTERS.dropped`, and
        the next call starts a new pass. With window_prefetch > 1 a window
        thread stacks and copies up to that many windows ahead, and this
        call takes the next one."""
        device = self.device if device is None else _resolve_device(device)
        if self.window_prefetch > 1:
            return self._next_window_prefetched(k, device)
        if self._consumer is None:
            self._consumer = self._batches(stage=False)
        feeds: List[Dict[str, Any]] = []
        try:
            while len(feeds) < k:
                feeds.append(next(self._consumer))
        except StopIteration:
            self._consumer = None
            COUNTERS.dropped += len(feeds)
            raise StopIteration from None
        except BaseException:
            self._consumer = None         # a failed pass starts anew
            raise
        COUNTERS.windows += 1
        return self._stack_window(feeds, device).hand_out(device)

    def _stack_window(self, feeds: List[Dict[str, Any]], device) -> _Staged:
        names = set(feeds[0])
        if any(set(f) != names for f in feeds[1:]):
            raise ValueError("window batches must share the same feed names")
        if device.type != "cuda":
            return _Staged({n: torch.from_numpy(np.stack(
                [np.asarray(f[n]) for f in feeds])) for n in sorted(names)},
                None)
        stream = self._copy_stream(device)
        out = {}
        with torch.cuda.device(device), torch.cuda.stream(stream):
            for n in sorted(names):
                arrs = [np.asarray(f[n]) for f in feeds]
                host = self._pinned_buffer(device, n, arrs)
                np.stack(arrs, out=host.numpy())
                out[n] = host.to(device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
                self._pinned[(device, n)][1] = done
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(out, event)

    def _pinned_buffer(self, device, name, arrs) -> torch.Tensor:
        """The reused pinned [k, ...] buffer of one feed name, once the last
        copy out of it has ended (made anew only when the shape or dtype
        changes)."""
        shape = (len(arrs),) + arrs[0].shape
        dtype = _torch_dtype(np.result_type(*arrs))
        slot = self._pinned.get((device, name))
        if slot is None or tuple(slot[0].shape) != shape or \
                slot[0].dtype != dtype:
            if slot is not None and slot[1] is not None:
                slot[1].synchronize()
            slot = self._pinned[(device, name)] = [
                torch.empty(shape, dtype=dtype, pin_memory=True), None]
        elif slot[1] is not None:
            slot[1].synchronize()
        return slot[0]

    def _produce_windows(self, k, device, wq, wstop):
        """The window thread: k batches at a time from the batch producer,
        stacked and copied, into the bounded window queue. `wq` and `wstop`
        are its own, so a window thread given up by a change of (k, device)
        can neither fill its successor's queue nor block forever on its
        own."""
        def _put(item):
            while not wstop.is_set():
                try:
                    wq.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            it = self._batches(stage=False, consumer=False)
            while not wstop.is_set():
                feeds: List[Dict[str, Any]] = []
                try:
                    while len(feeds) < k:
                        feeds.append(next(it))
                except StopIteration:
                    # the consumer counts the drop when it takes this
                    # marker: a count here would race its reads
                    _put((_STOP, len(feeds)))
                    return
                if not _put(self._stack_window(feeds, device)):
                    return
        except Exception as e:  # noqa: BLE001 - raised in the consumer
            _put(e)

    def _next_window_prefetched(self, k, device):
        key = (k, device)
        if self._wthread is None or self._wkey != key:
            self._stop_windows()
            self._wkey = key
            self._wstop = threading.Event()
            self._wqueue = queue.Queue(maxsize=self.window_prefetch)
            self._wthread = threading.Thread(
                target=self._produce_windows,
                args=(k, device, self._wqueue, self._wstop),
                daemon=True, name="pd-feeder-window")
            self._wthread.start()
        t0 = time.perf_counter()
        item = self._wqueue.get()
        COUNTERS.wait_s += time.perf_counter() - t0
        if type(item) is tuple and len(item) == 2 and item[0] is _STOP:
            COUNTERS.dropped += item[1]
            self._wthread.join()
            self._wthread = None
            self._wkey = None
            raise StopIteration
        if isinstance(item, Exception):
            self._wthread.join()
            self._wthread = None
            self._wkey = None
            raise item
        COUNTERS.windows += 1
        return item.hand_out(device)

    # --- lifetime -----------------------------------------------------------
    def _stop_windows(self):
        # the window thread resets the batch producer itself (_batches ->
        # reset -> stop); it never joins itself from there
        if self._wthread is None or \
                self._wthread is threading.current_thread():
            return
        self._wstop.set()
        try:                      # unblock a window thread awaiting a batch
            self._queue.put_nowait(_STOP)
        except (queue.Full, AttributeError):
            pass
        try:                      # unblock a window thread waiting to put one
            while True:
                self._wqueue.get_nowait()
        except queue.Empty:
            pass
        self._wthread.join(timeout=5)
        self._wthread = None
        self._wkey = None

    def reset(self, stage=True):
        """Stop any pass in flight and start the producer on a new one."""
        self.stop()
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self.capacity)
        self._thread = threading.Thread(
            target=self._produce, args=(self._queue, self._stop, stage),
            daemon=True, name="pd-feeder-batch")
        self._thread.start()

    def stop(self):
        """Stop the window thread and the batch producer."""
        self._stop_windows()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._stop.set()
            try:                  # unblock a producer waiting to put
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            self._thread = None


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype
