"""Tables larger than the card: a hot-row cache on the card over a host-DRAM
authoritative store (the port's counterpart of
paddle_tpu/parallel/emb_cache.py).

The authoritative table lives in host memory, one slab per table and per
optimizer accumulator (pinned CPU tensors when the table lived on a CUDA
device, so the copies run asynchronously), while the program sees only a
[cache_rows, dim] **cache slab** on the card. Ids are remapped to slab
slots on the host before they cross, so every shape stays static:

  * `lookup_table` gathers from the slab with slot indices;
  * the sparse applies (ops/sparse_ops.py, S1 on the card) update the slab
    in place: the gradient's rows are slot indices already.

The touched rows' numbers equal the uncached path's: the remap is
elementwise, so the merge sums the same values in the same order and the
update math reads the same row values (tests/test_torch_emb_cache.py).

Residency (`EmbCache`), with the reference's bookkeeping, so hits, misses,
evictions and compulsory misses equal the JAX package's on one id stream:

  * `prepare_feed(feed)`: make every id of the feed resident (`_ensure`),
    remap ids to slots, mark the slots dirty, and make the compute stream
    wait for the rows staged into the slab.
  * `prefetch(uniq)`: the overlapped half, on a thread of its own: resolve
    the next window's unique ids (DoubleBufferedFeeder.next_window(...,
    sparse_slots=[...])) and stage the missing rows into victim slots
    while the current window computes. Victims go least recently used
    first, the less frequently hit first among equals; a dirty victim is
    flushed to the host slab first.
  * `flush()`: write every dirty slot back to the host slab (io.py calls
    it before a checkpoint and writes the host slab in the cache slab's
    place).

Where the JAX package's arrays are immutable, the port writes the slab in
place, and the bucket graphs and training graphs captured its address, so
the slab keeps its storage: rows go in with `index_copy_`, and the scope
(or the serving engine's state) is never handed a new tensor for it.
Staging into a slot the in-flight window still reads or updates would
race, so on the card every slab write and every read of a dirty victim
runs on the cache's copy stream after the in-flight window's event
(`window_dispatched`, recorded by the executor after each run or window),
while the host half (id resolution, the gather from the host slab into
pinned staging) runs as soon as it is called. The compute stream waits on
the last staging before the next window.

Gating: `PADDLE_TPU_EMB_CACHE=0` switches it off; a table opts in through
`layers.embedding(..., cache_rows=N)` or `enable(program,
budget_bytes=...)`. Telemetry: the `emb_cache_*` series of the reference.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "CACHE_AWARE_OPS", "cache_enabled", "request_cache", "requested_rows",
    "rows_for_budget", "budget_from_headroom", "enable", "enable_serving",
    "active_cache", "EmbCache",
]


def _cache_aware_ops() -> frozenset:
    from ..ops import sparse_ops
    return frozenset(
        {"lookup_table", "lookup_table_grad"}
        | set(sparse_ops.SPARSE_APPLY_OPS)
        | {"fused_sparse_" + t for t in sparse_ops.SPARSE_APPLY_OPS})


#: The ops allowed to reference a cached table: each gathers with the
#: remapped feed ids or applies a SelectedRows gradient whose rows are those
#: slots, so none ever indexes the slab with a global row id.
CACHE_AWARE_OPS: frozenset = _cache_aware_ops()

_EVICT_POLICY = "lru_freq"


def cache_enabled() -> bool:
    """PADDLE_TPU_EMB_CACHE switch (default on), read by enable."""
    return os.environ.get("PADDLE_TPU_EMB_CACHE", "1") != "0"


def request_cache(program, param_name: str, cache_rows: int):
    """Record a table's request (layers.embedding(cache_rows=N));
    `enable(program)` activates every recorded table."""
    req = getattr(program, "_emb_cache_rows", None)
    if req is None:
        req = program._emb_cache_rows = {}
    req[param_name] = int(cache_rows)
    return program


def requested_rows(program) -> Dict[str, int]:
    return dict(getattr(program, "_emb_cache_rows", None) or {})


def active_cache(program) -> Optional["EmbCache"]:
    return getattr(program, "_emb_cache", None)


def rows_for_budget(budget_bytes: int, dim: int, itemsize: int,
                    n_state: int) -> int:
    """The cache rows `budget_bytes` of device memory afford: a row costs
    dim * itemsize for the table and as much for each cached
    accumulator."""
    row_bytes = max(1, int(dim) * int(itemsize) * max(1, int(n_state)))
    return max(0, int(budget_bytes) // row_bytes)


def budget_from_headroom(model, batch: int, limit_bytes: Optional[int] = None,
                         window_feed_bytes: int = 0) -> int:
    """Device bytes left for cache slabs (emb_cache.py:129): the memory
    limit (memory.default_budget: the card's, unless given) less the
    memory.HeadroomModel's predicted peak at `batch`, less the window's
    feed buffer (run_steps stages K batches on the card). Fit the model
    from measured peaks (Executor.measure_memory), then size the cache
    from what is left."""
    from .. import memory as memory_mod
    limit = int(limit_bytes) if limit_bytes else memory_mod.default_budget()
    return int(model.headroom(limit, batch)) - int(window_feed_bytes)


def _host_slab(v: torch.Tensor) -> torch.Tensor:
    """A host copy of `v`: pinned when `v` lives on a CUDA device."""
    if v.device.type == "cuda":
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host.copy_(v)
        return host
    return v.detach().clone()


class _CachedTable:
    """One table's residency: the host slabs of the table and each
    accumulator, the id -> slot and slot -> id maps, and the eviction
    bookkeeping (the JAX package's emb_cache.py:141)."""

    def __init__(self, name: str, rows: int, dim: int, cache_rows: int,
                 state_names: Sequence[str], ids_inputs: Sequence[str]):
        self.name = name
        self.rows = int(rows)
        self.dim = int(dim)
        self.cache_rows = int(cache_rows)
        self.state_names = list(state_names)     # the table first
        self.ids_inputs = list(ids_inputs)       # feed names
        self.host: Dict[str, torch.Tensor] = {}
        self.id2slot = np.full(self.rows, -1, dtype=np.int32)
        self.slot2id = np.full(self.cache_rows, -1, dtype=np.int64)
        # ids ever counted: a miss of one never seen is compulsory
        self.ever = np.zeros(self.rows, dtype=bool)
        self.freq = np.zeros(self.cache_rows, dtype=np.int64)
        self.last_used = np.zeros(self.cache_rows, dtype=np.int64)
        self.dirty = np.zeros(self.cache_rows, dtype=bool)
        self.tick = 0
        # (unique ids, the ids it staged as misses) of the last prefetch
        self.prefetch_pending = None
        # per lookup, not per unique id
        self.hits = 0
        self.misses = 0
        self.miss_compulsory = 0
        self.evictions = 0


class _PrefetchHandle:
    """Join handle of one background prefetch. `wait()` records how much of
    the prefetch's wall time passed before the caller reached it (the
    caller dispatched the window first, so that time ran beside it)."""

    def __init__(self, cache: "EmbCache", work: Callable[[], None]):
        self._cache = cache
        self._t0 = 0.0
        self._t1 = 0.0
        self._err: Optional[BaseException] = None

        def run():
            self._t0 = time.perf_counter()
            try:
                work()
            except BaseException as e:   # raised again at wait()
                self._err = e
            self._t1 = time.perf_counter()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="pd-emb-prefetch")
        self._thread.start()

    def wait(self):
        t_enter = time.perf_counter()
        self._thread.join()
        dur = max(self._t1 - self._t0, 0.0)
        overlapped = min(max(min(self._t1, t_enter) - self._t0, 0.0), dur)
        self._cache._note_overlap(dur, overlapped)
        if self._err is not None:
            raise self._err
        return self


class EmbCache:
    """Hot-row cache over host-DRAM authoritative tables. `get_state`
    reaches where the slabs live (the scope when training, the serving
    engine's state when serving, `read_only=True`); the cache writes them
    in place and never replaces one. Every change of the maps or the slabs
    happens under one lock."""

    def __init__(self, program, tables: Sequence[_CachedTable],
                 get_state: Callable, read_only: bool = False, device=None):
        self.program = program
        self.read_only = read_only
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._tables: Dict[str, _CachedTable] = {t.name: t for t in tables}
        self._get_state = get_state
        self._lock = threading.RLock()
        self._prefetch_seconds = 0.0
        self._overlap_seconds = 0.0
        self._flush_bytes = 0
        self._ids_to_table: Dict[str, str] = {}
        for t in tables:
            for n in t.ids_inputs:
                self._ids_to_table[n] = t.name
        # on a CUDA device: the copy stream, the in-flight window's event,
        # and the event that ends the last staging into a slab
        self._stream = None
        self._inflight = None
        self._staged = None

    # --- introspection ------------------------------------------------------
    def tables(self) -> Dict[str, _CachedTable]:
        return dict(self._tables)

    def feed_id_names(self) -> List[str]:
        return sorted(self._ids_to_table)

    def hit_rate(self, table: Optional[str] = None) -> float:
        with self._lock:
            ts = ([self._tables[table]] if table
                  else list(self._tables.values()))
            h = sum(t.hits for t in ts)
            m = sum(t.misses for t in ts)
        return h / (h + m) if (h + m) else 0.0

    def stats(self) -> Dict[str, object]:
        with self._lock:
            ts = self._tables.values()
            return {
                "hits": sum(t.hits for t in ts),
                "misses": sum(t.misses for t in ts),
                "compulsory_misses": sum(t.miss_compulsory for t in ts),
                "hit_rate": self.hit_rate(),
                "evictions": sum(t.evictions for t in ts),
                "flush_bytes": self._flush_bytes,
                "prefetch_seconds": self._prefetch_seconds,
                "overlap_seconds": self._overlap_seconds,
                "overlap_fraction": (
                    self._overlap_seconds / self._prefetch_seconds
                    if self._prefetch_seconds > 0 else 0.0),
                "tables": {
                    n: {"cache_rows": t.cache_rows, "rows": t.rows,
                        "resident": int((t.slot2id >= 0).sum()),
                        "hits": t.hits, "misses": t.misses,
                        "compulsory_misses": t.miss_compulsory,
                        "evictions": t.evictions}
                    for n, t in self._tables.items()},
            }

    # --- the card ---------------------------------------------------------
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def _copy_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def window_dispatched(self):
        """Record, on the compute stream, the end of the run just
        dispatched: later slab writes and dirty reads wait for it."""
        if self._cuda():
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._inflight = ev

    def _after_inflight(self, stream):
        if self._inflight is not None:
            stream.wait_event(self._inflight)

    def _slab(self, name: str) -> torch.Tensor:
        v = self._get_state(name)
        if v is None:
            raise RuntimeError(
                f"emb_cache: device slab '{name}' vanished from its "
                f"store — was the scope cleared after enable()?")
        return v

    def _stage(self, t: _CachedTable, victims: np.ndarray,
               miss_ids: np.ndarray):
        """Rows `miss_ids` of the host slabs into slots `victims` of the
        cache slabs, in place."""
        ids = torch.from_numpy(miss_ids.astype(np.int64))
        slots = torch.from_numpy(victims.astype(np.int64))
        if not self._cuda():
            for name in t.state_names:
                self._slab(name).index_copy_(
                    0, slots, t.host[name].index_select(0, ids))
            return
        staged = {}
        for name in t.state_names:   # the host half: into pinned staging
            host = t.host[name]
            buf = torch.empty((ids.numel(),) + tuple(host.shape[1:]),
                              dtype=host.dtype, pin_memory=True)
            torch.index_select(host, 0, ids, out=buf)
            staged[name] = buf
        slots = slots.pin_memory()
        stream = self._copy_stream()
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            self._after_inflight(stream)
            dslots = slots.to(self.device, non_blocking=True)
            for name, buf in staged.items():
                self._slab(name).index_copy_(
                    0, dslots, buf.to(self.device, non_blocking=True))
            ev = torch.cuda.Event()
            ev.record(stream)
        self._staged = ev

    def _read_back(self, t: _CachedTable, slots: np.ndarray,
                   ids: np.ndarray) -> int:
        """Rows `slots` of the cache slabs into rows `ids` of the host
        slabs; returns the bytes written."""
        idx = torch.from_numpy(slots.astype(np.int64))
        hid = torch.from_numpy(ids.astype(np.int64))
        total = 0
        if not self._cuda():
            for name in t.state_names:
                vals = self._slab(name).index_select(0, idx)
                t.host[name].index_copy_(0, hid, vals)
                total += vals.numel() * vals.element_size()
            return total
        stream = self._copy_stream()
        outs = {}
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            self._after_inflight(stream)
            didx = idx.pin_memory().to(self.device, non_blocking=True)
            for name in t.state_names:
                vals = self._slab(name).index_select(0, didx)
                buf = torch.empty(vals.shape, dtype=vals.dtype,
                                  pin_memory=True)
                buf.copy_(vals, non_blocking=True)
                outs[name] = buf
            ev = torch.cuda.Event()
            ev.record(stream)
        ev.synchronize()
        for name, buf in outs.items():
            t.host[name].index_copy_(0, hid, buf)
            total += buf.numel() * buf.element_size()
        return total

    # --- residency --------------------------------------------------------
    def _ensure(self, t: _CachedTable, uniq: np.ndarray, count: bool,
                counts: Optional[np.ndarray] = None,
                premissed: Optional[np.ndarray] = None):
        """Make every id of sorted-unique `uniq` resident (the JAX
        package's emb_cache.py:304). Caller holds the lock. `counts` are
        per-id occurrences (hits and misses count per lookup);
        `count=False` stages without counting (a prefetch: the consuming
        prepare_feed counts, charging the prefetch's `premissed` ids as
        misses)."""
        if uniq.size and (int(uniq[0]) < 0 or int(uniq[-1]) >= t.rows):
            bad = uniq[(uniq < 0) | (uniq >= t.rows)]
            raise ValueError(
                f"emb_cache: ids out of range for table '{t.name}' "
                f"([0, {t.rows})): {bad[:8].tolist()}")
        if counts is None:
            counts = np.ones(uniq.size, dtype=np.int64)
        slots = t.id2slot[uniq]
        miss_mask = slots < 0
        if count:
            cmask = (np.isin(uniq, premissed, assume_unique=True)
                     if premissed is not None else miss_mask)
            n_miss = int(counts[cmask].sum())
            n_hit = int(counts.sum()) - n_miss
            t.hits += n_hit
            t.misses += n_miss
            t.miss_compulsory += int(counts[cmask & ~t.ever[uniq]].sum())
            t.ever[uniq] = True
            self._record_rate(t, n_hit, n_miss)
        t.tick += 1
        hit_slots = slots[~miss_mask]
        t.freq[hit_slots] += counts[~miss_mask]
        t.last_used[hit_slots] = t.tick
        n_miss = int(miss_mask.sum())
        if n_miss == 0:
            return
        if int(uniq.size) > t.cache_rows:
            raise RuntimeError(
                f"emb_cache: one window touches {uniq.size} unique rows "
                f"of '{t.name}' but cache_rows={t.cache_rows} — every "
                f"step of a window runs against one slab, so the window "
                f"union must fit; raise cache_rows above the touched-row "
                f"bound or lower the batch size / window length")
        miss_ids = uniq[miss_mask]
        blocked = np.zeros(t.cache_rows, dtype=bool)
        blocked[hit_slots] = True
        free = np.flatnonzero((t.slot2id < 0) & ~blocked)
        victims = free[:n_miss]
        need = n_miss - victims.size
        if need > 0:
            # least recently used first, the less frequently hit first
            # among equals, ties by slot: the reference's lexsort over every
            # occupied slot, sorting only the slots no newer than the
            # need-th oldest (the same victims, without sorting the slab)
            occ = np.flatnonzero((t.slot2id >= 0) & ~blocked)
            used = t.last_used[occ]
            cand = occ[used <= np.partition(used, need - 1)[need - 1]]
            order = np.lexsort((t.freq[cand], t.last_used[cand]))
            evict = cand[order[:need]]
            self._evict(t, evict)
            victims = np.concatenate([victims, evict])
        t.slot2id[victims] = miss_ids
        t.id2slot[miss_ids] = victims.astype(np.int32)
        t.freq[victims] = counts[miss_mask]
        t.last_used[victims] = t.tick
        t.dirty[victims] = False
        self._stage(t, victims, miss_ids)

    def _evict(self, t: _CachedTable, slots: np.ndarray):
        """Flush the dirty victims to the host slab, then unmap them."""
        old_ids = t.slot2id[slots]
        live = old_ids >= 0
        dirty = slots[live & t.dirty[slots]]
        if dirty.size and not self.read_only:
            self._record_flush(self._read_back(t, dirty, t.slot2id[dirty]))
        t.id2slot[old_ids[live]] = -1
        t.slot2id[slots] = -1
        t.dirty[slots] = False
        t.evictions += int(slots.size)
        from .. import telemetry
        telemetry.counter(
            "emb_cache_evictions_total",
            "hot-row cache slots evicted, by victim-selection policy",
            labels=("policy",)).labels(policy=_EVICT_POLICY).inc(
                int(slots.size))

    def _wait_staged(self):
        if self._staged is not None:
            torch.cuda.current_stream(self.device).wait_event(self._staged)

    # --- the protocol -------------------------------------------------------
    def prepare_feed(self, feed: Dict) -> Dict:
        """Make every cached table's ids in `feed` resident and return the
        feed with those ids remapped to slot indices (numpy, of the ids'
        dtype). One step's [B, ...] ids and a window's [K, B, ...] alike:
        the union of a window must be resident at once. Ids are read on
        the host; ids handed in on the card are copied back first."""
        present = [n for n in self._ids_to_table if n in feed]
        if not present:
            return feed
        out = dict(feed)
        with self._lock:
            by_table: Dict[str, List[str]] = {}
            for n in present:
                by_table.setdefault(self._ids_to_table[n], []).append(n)
            for tname, names in sorted(by_table.items()):
                t = self._tables[tname]
                arrs = {}
                for n in names:
                    v = feed[n]
                    if isinstance(v, torch.Tensor):
                        v = v.detach().cpu().numpy()
                    arrs[n] = np.asarray(v)
                uniq, counts = np.unique(
                    np.concatenate([a.ravel() for a in arrs.values()]),
                    return_counts=True)
                uniq = uniq.astype(np.int64)
                premissed = self._consume_prefetch(t, uniq)
                self._ensure(t, uniq, count=True,
                             counts=counts.astype(np.int64),
                             premissed=premissed)
                if not self.read_only:
                    # the run applies its updates to exactly these slots
                    t.dirty[t.id2slot[uniq]] = True
                for n, a in arrs.items():
                    out[n] = t.id2slot[a].astype(a.dtype)
            if self._cuda():
                self._wait_staged()
        return out

    def _consume_prefetch(self, t: _CachedTable, uniq: np.ndarray
                          ) -> Optional[np.ndarray]:
        """The ids the last prefetch staged as misses, if it covered this
        request; else None."""
        pending, t.prefetch_pending = t.prefetch_pending, None
        if pending is None:
            return None
        puniq, pmissed = pending
        if uniq.size and bool(np.isin(uniq, puniq,
                                      assume_unique=True).all()):
            return pmissed
        return None

    def prefetch(self, uniq_map: Dict[str, np.ndarray]) -> _PrefetchHandle:
        """Stage the next window's rows on a thread of its own while the
        current window computes. `uniq_map`: feed id names (or table names)
        -> unique ids, as next_window(..., sparse_slots=[...]) returns
        them. Call handle.wait() before the next prepare_feed."""
        staged: Dict[str, np.ndarray] = {}
        for key, ids in (uniq_map or {}).items():
            tname = self._ids_to_table.get(key, key)
            if tname not in self._tables:
                continue
            if isinstance(ids, torch.Tensor):
                ids = ids.cpu().numpy()
            ids = np.asarray(ids).ravel().astype(np.int64)
            prev = staged.get(tname)
            staged[tname] = ids if prev is None else np.concatenate([prev,
                                                                     ids])

        def work():
            from .. import telemetry
            with self._lock:
                for tname, ids in sorted(staged.items()):
                    t = self._tables[tname]
                    uniq = np.unique(ids)
                    missed = uniq[t.id2slot[uniq] < 0]
                    self._ensure(t, uniq, count=False)
                    t.prefetch_pending = (uniq, missed)
            telemetry.counter(
                "emb_cache_prefetch_total",
                "background hot-row prefetches issued").inc()

        return _PrefetchHandle(self, work)

    def flush(self) -> int:
        """Write every dirty slot back to the host slabs (the checkpoint
        barrier). Returns the bytes written."""
        total = 0
        with self._lock:
            for t in self._tables.values():
                d = np.flatnonzero(t.dirty & (t.slot2id >= 0))
                if d.size:
                    total += self._read_back(t, d, t.slot2id[d])
                t.dirty[:] = False
        if total:
            self._record_flush(total)
        return total

    def host_value(self, state_name: str) -> Optional[np.ndarray]:
        """The authoritative host slab of a cached state var, as a numpy
        view (None when the var is not cached). flush() first for current
        values."""
        with self._lock:
            for t in self._tables.values():
                if state_name in t.state_names:
                    return t.host[state_name].numpy()
        return None

    def load_host(self, state_name: str, arr) -> bool:
        """Restore a checkpoint into the host slab (in place) and invalidate
        the table's residency: every slot stages anew on first touch.
        Returns False when the var is not cached."""
        with self._lock:
            for t in self._tables.values():
                if state_name not in t.state_names:
                    continue
                host = t.host[state_name]
                src = torch.as_tensor(np.ascontiguousarray(arr))
                if tuple(src.shape) != tuple(host.shape):
                    raise ValueError(
                        f"emb_cache: restore of '{state_name}' has shape "
                        f"{tuple(src.shape)}, expected {tuple(host.shape)} "
                        f"(the checkpoint holds the FULL host table, not "
                        f"the cache slab)")
                host.copy_(src)
                t.id2slot[:] = -1
                t.slot2id[:] = -1
                t.freq[:] = 0
                t.last_used[:] = 0
                t.dirty[:] = False
                t.prefetch_pending = None
                return True
        return False

    # --- telemetry ----------------------------------------------------------
    def _record_rate(self, t: _CachedTable, n_hit: int, n_miss: int):
        from .. import telemetry
        if n_hit:
            telemetry.counter(
                "emb_cache_hits_total", "hot-row cache id hits",
                labels=("table",)).labels(table=t.name).inc(n_hit)
        if n_miss:
            telemetry.counter(
                "emb_cache_misses_total",
                "hot-row cache id misses (rows staged from host DRAM)",
                labels=("table",)).labels(table=t.name).inc(n_miss)
        total = t.hits + t.misses
        if total:
            telemetry.gauge(
                "emb_cache_hit_rate",
                "cumulative hot-row cache hit rate (hits / ids resolved)",
                labels=("table",)).labels(table=t.name).set(t.hits / total)

    def _note_overlap(self, dur: float, overlapped: float):
        from .. import telemetry
        with self._lock:
            self._prefetch_seconds += dur
            self._overlap_seconds += overlapped
            frac = (self._overlap_seconds / self._prefetch_seconds
                    if self._prefetch_seconds > 0 else 0.0)
        telemetry.gauge(
            "emb_cache_prefetch_overlap_fraction",
            "fraction of prefetch wall time hidden behind the in-flight "
            "window's compute").set(frac)

    def _record_flush(self, nbytes: int):
        from .. import telemetry
        with self._lock:
            self._flush_bytes += int(nbytes)
        telemetry.counter(
            "emb_cache_flush_bytes_total",
            "dirty hot-row bytes written back to the host-DRAM "
            "authoritative store").inc(int(nbytes))


# --- activation -------------------------------------------------------------

def _discover(program, only: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    """{table: {dim, rows, ids}} for every lookup_table W the cache could
    serve, with the checks that keep the remap sound (emb_cache.py:596)."""
    blk = program.global_block()
    found: Dict[str, Dict] = {}
    produced = {n for op in blk.ops for n in op.output_arg_names}
    for op in blk.ops:
        if op.type != "lookup_table":
            continue
        wname = (op.input("W") or [None])[0]
        ids = (op.input("Ids") or [None])[0]
        if not wname or not blk.has_var(wname):
            continue
        if only is not None and wname not in only:
            continue
        if int(op.desc.attrs.get("padding_idx", -1)) >= 0:
            raise ValueError(
                f"emb_cache: table '{wname}' uses padding_idx — the "
                f"lookup compares raw ids against it, which slot "
                f"remapping breaks; drop padding_idx or the cache")
        if not op.desc.attrs.get("is_sparse", False):
            raise ValueError(
                f"emb_cache: table '{wname}' has is_sparse=False — a "
                f"dense gradient would update every cache slot "
                f"(including stale tenants); build the embedding with "
                f"is_sparse=True so only touched slots scatter-apply")
        if ids in produced:
            raise ValueError(
                f"emb_cache: ids '{ids}' of table '{wname}' are computed "
                f"in-graph; the cache remaps ids at feed time, so they "
                f"must be a fed input")
        ent = found.setdefault(wname, {"ids": []})
        if ids not in ent["ids"]:
            ent["ids"].append(ids)
    from . import embedding as embedding_mod
    for wname, ent in found.items():
        if wname in embedding_mod.sharded_tables(program):
            raise ValueError(
                f"emb_cache: table '{wname}' is row-sharded "
                f"(_sharded_tables) — the hot-row cache replaces the "
                f"beyond-HBM role of sharding; pick one per table")
        offenders = [f"op[{i}] {op.type}" for i, op in enumerate(blk.ops)
                     if wname in (set(op.input_arg_names)
                                  | set(op.output_arg_names))
                     and op.type not in CACHE_AWARE_OPS]
        if offenders:
            raise ValueError(
                f"emb_cache: table '{wname}' is referenced by "
                f"{offenders}, which have no slot-remap path "
                f"(CACHE_AWARE_OPS = {sorted(CACHE_AWARE_OPS)}) — such "
                f"an op would index the cache slab with global row ids")
        shp = tuple(blk.var(wname).shape or ())
        ent["rows"] = int(shp[0])
        ent["dim"] = int(shp[1]) if len(shp) > 1 else 1
    return found


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else \
        torch.as_tensor(np.asarray(v))


def enable(program, budget_bytes: Optional[int] = None,
           tables: Optional[Dict[str, int]] = None,
           scope=None, headroom=None, batch: Optional[int] = None,
           limit_bytes: Optional[int] = None,
           window_feed_bytes: int = 0) -> Optional[EmbCache]:
    """Activate the hot-row cache on `program`, after the startup program
    (and the optimizer's minimize) ran: the table and its accumulators
    must be in the scope.

    cache_rows per table: an explicit `tables={name: cache_rows}` entry, a
    layers.embedding(cache_rows=N) request, or `budget_bytes` split evenly
    over the other tables (a row costs dim * itemsize * (1 +
    accumulators)); or, with `headroom=` (a memory.HeadroomModel) and
    `batch=`, the budget `budget_from_headroom` leaves under
    `limit_bytes` (memory.default_budget by default) after the window's
    feed buffer `window_feed_bytes`. A table whose cache would hold it
    whole stays uncached. Each cached state var's full value moves to a
    host slab, and the scope gets a [cache_rows, dim] slab of zeros on the
    var's device; the cache goes on `program._emb_cache`, and the executor
    remaps feeds from then on. Returns the cache, or None when PADDLE_TPU_EMB_CACHE is
    off or nothing needs caching."""
    if not cache_enabled():
        return None
    from .. import executor as executor_mod
    from . import embedding as embedding_mod
    scope = scope if scope is not None else executor_mod.global_scope()
    if getattr(program, "_emb_cache", None) is not None:
        return program._emb_cache
    requested = requested_rows(program)
    only = list(tables) if tables is not None else \
        (list(requested) if requested else None)
    if budget_bytes is None and headroom is not None:
        if batch is None:
            raise ValueError("enable(headroom=...) needs batch=")
        budget_bytes = budget_from_headroom(
            headroom, batch, limit_bytes, window_feed_bytes)
    found = _discover(program, only)
    if not found:
        return None
    sized_by_budget = [w for w in found
                       if not (tables and w in tables) and w not in requested]
    specs: List[_CachedTable] = []
    device = None
    for wname, ent in sorted(found.items()):
        state = [wname] + embedding_mod.table_accumulators(program, wname)
        if tables and wname in tables:
            cache_rows = int(tables[wname])
        elif wname in requested:
            cache_rows = int(requested[wname])
        elif budget_bytes is not None:
            v = scope.find_var(wname)
            itemsize = _as_tensor(v).element_size() if v is not None else 4
            cache_rows = rows_for_budget(
                max(0, int(budget_bytes)) // max(1, len(sized_by_budget)),
                ent["dim"], itemsize, len(state))
        else:
            raise ValueError(
                f"emb_cache.enable: no cache_rows for table '{wname}' — "
                f"pass budget_bytes=/tables= or build the layer with "
                f"cache_rows=")
        if cache_rows >= ent["rows"]:
            continue   # it fits as it is
        if cache_rows < 1:
            raise ValueError(
                f"emb_cache.enable: budget leaves {cache_rows} cache "
                f"rows for table '{wname}' ({ent['rows']}x{ent['dim']}) "
                f"— raise budget_bytes")
        t = _CachedTable(wname, ent["rows"], ent["dim"], cache_rows,
                         state, ent["ids"])
        for name in state:
            v = scope.find_var(name)
            if v is None:
                raise RuntimeError(
                    f"emb_cache.enable: '{name}' is absent from the "
                    f"scope — run the startup program (and the "
                    f"optimizer's minimize) before enabling the cache")
            v = _as_tensor(v)
            if v.shape[0] != ent["rows"]:
                raise ValueError(
                    f"emb_cache.enable: scope var '{name}' has "
                    f"{v.shape[0]} rows, table declares {ent['rows']}")
            device = v.device
            t.host[name] = _host_slab(v)
            scope.set_var(name, torch.zeros((cache_rows,) + tuple(v.shape[1:]),
                                            dtype=v.dtype, device=v.device))
        specs.append(t)
    if not specs:
        return None
    cache = EmbCache(program, specs, get_state=scope.find_var, device=device)
    program._emb_cache = cache
    # the state's shapes changed: the executor's plans and graphs key on it
    program._version = getattr(program, "_version", 0) + 1
    from .. import telemetry
    telemetry.log_event(
        "emb_cache_enable",
        tables={t.name: {"rows": t.rows, "cache_rows": t.cache_rows,
                         "state": len(t.state_names)} for t in specs},
        budget_bytes=budget_bytes)
    return cache


def enable_serving(engine, budget_bytes: Optional[int] = None,
                   tables: Optional[Dict[str, int]] = None
                   ) -> Optional[EmbCache]:
    """The read-only cache of a serving.ServingEngine: the engine's resident
    state holds the slab, a request's ids remap under the engine lock,
    misses stage from the host slab, and eviction never flushes (serving
    writes no row). The engine calls it when built with
    emb_cache_budget_bytes= or emb_cache_tables=, before any bucket graph
    is captured."""
    if not cache_enabled():
        return None
    program = engine.program
    found = _discover(program, list(tables) if tables else None)
    found = {w: e for w, e in found.items()
             if set(e["ids"]) <= set(engine.feed_names)}
    if not found:
        return None
    specs: List[_CachedTable] = []
    for wname, ent in sorted(found.items()):
        full = _as_tensor(engine._state[wname])
        if full.shape[0] != ent["rows"]:
            raise ValueError(
                f"emb_cache.enable_serving: resident '{wname}' has "
                f"{full.shape[0]} rows but the program declares "
                f"{ent['rows']} — the saved model appears to hold a "
                f"cache slab instead of the full table (was it exported "
                f"without flushing the training-side cache?)")
        if tables and wname in tables:
            cache_rows = int(tables[wname])
        elif budget_bytes is not None:
            cache_rows = rows_for_budget(
                max(0, int(budget_bytes)) // max(1, len(found)),
                ent["dim"], full.element_size(), 1)
        else:
            raise ValueError("enable_serving needs budget_bytes= or "
                             "tables=")
        if cache_rows >= ent["rows"]:
            continue
        if cache_rows < 1:
            raise ValueError(
                f"emb_cache.enable_serving: budget leaves {cache_rows} "
                f"cache rows for '{wname}' — raise the budget")
        t = _CachedTable(wname, ent["rows"], ent["dim"], cache_rows,
                         [wname], ent["ids"])
        t.host[wname] = _host_slab(full)
        engine._state[wname] = torch.zeros(
            (cache_rows,) + tuple(full.shape[1:]), dtype=full.dtype,
            device=full.device)
        specs.append(t)
    if not specs:
        return None
    cache = EmbCache(program, specs,
                     get_state=engine._state.get, read_only=True,
                     device=engine.device)
    from .. import telemetry
    telemetry.log_event(
        "emb_cache_enable_serving",
        tables={t.name: {"rows": t.rows, "cache_rows": t.cache_rows}
                for t in specs})
    return cache
