"""Training-dynamics observatory: per-layer parameter/gradient health
time-series computed on the card (the port's counterpart of
paddle_tpu/dynamics.py, with its fields, THRESHOLDS, HEALTH_CATALOG,
verdicts and host half as they are).

The reference framework's `show_parameter_stats_period` prints
per-parameter value/grad/momentum magnitudes every N batches by syncing
each tensor to the host. This module computes the whole table as one
grouped reduction inside the step: `plan()` resolves each trainable
parameter's grad var and optimizer moments, `group_rows()` emits a single
[groups, fields] float32 tensor from the step's old and new state and its
gradients, and the executor ships it back with the fetches.

Sampling. The reference gates its reduction with `lax.cond` on the device
step counter (paddle_tpu/dynamics.py:395-421). A CUDA graph has no such
branch, and the host knows the counter, so the executor captures two
graphs per signature, a sampled one and a plain one, and replays the
sampled one on steps whose counter is a multiple of the period
(`sampled(plan, counter)`); `cache_token` is in the graph key, as the
reference puts it in its cache key. The graphs share the executor's pool
and state buffers. A sampled step reads W_old from the step's state as it
was before the graph writes its new values back, so a dense parameter
needs no copy; a table its sparse apply updates in place is read from the
executor's pre-step copy (executor.py `_PreStep`).

Launches. The reduction is grouped: `torch._foreach_norm` over all the
parameters (l2 and max-abs), over W_new - W_old, over the gradients and
their signs (the nonzero count, an L1 norm of the signs) and over the
moments, then the per-parameter sums added into their groups with one
`index_add_`, instead of one reduction per field and parameter. A
SelectedRows gradient reduces over the rows it touched: its parameter's
weight, update and moment statistics take those rows
(`index_select`), and the gradient is never densified.

Three layers:

1. **On the card** — per-series {weight l2/rms/max-abs, grad l2/rms/zero-frac,
   update ratio sqrt(sum dW^2)/(||W||+eps), optimizer-moment rms}. Series are
   per-parameter on small programs and collapse to planner roles
   (parallel.planner.classify_params: embedding/attn_qkv/ffn_up/...) past
   MAX_PARAM_SERIES, bounding cardinality on large programs. Fields
   with nothing to measure (no grad writer, no moments, no update this step)
   carry the -1.0 absent sentinel; NaN therefore always means genuinely
   non-finite values.
2. **History + verdicts** — a bounded ring per series with EWMA baselines,
   classifying each sample into the stable codes of HEALTH_CATALOG
   (dead-layer / frozen-param / exploding-update / saturating / ...). The
   grad-status half of the catalog is shared with inspector.GradientAudit,
   which delegates to `classify_grad()` so the two planes can never disagree
   on what "vanishing" means. Samples also stream to a JSONL file next to
   the telemetry step log (PADDLE_TPU_DYNAMICS_LOG overrides).
3. **Surfacing** — dynamics_* gauges, `payload()` (the reference's
   /dynamics endpoint body; the port's obs server is ROADMAP 10b-2) and a
   crash-report section.

Knobs: PADDLE_TPU_DYNAMICS=1 turns it on (the port's default is off, where
the reference's is on: on a graph it costs a second capture per signature,
so it is a plane the caller turns on), PADDLE_TPU_DYNAMICS_PERIOD (default
16) sets the sampling period; both read per plan, so tests can flip them
with override(). The eager path does not sample: dynamics rides the
graphed step (and its eager warm-up) only.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import flags, telemetry
from .framework.desc import VarType
from .framework.framework import grad_var_name
from .ops.common import SelectedRowsVal

STATE_KEY = "__dynamics__"

STAT_FIELDS = (
    "weight_l2", "weight_rms", "weight_max_abs",
    "grad_l2", "grad_rms", "grad_zero_frac",
    "update_ratio", "moment_rms",
)

# fields that may legitimately be absent (-1.0 on device -> None on host)
_OPTIONAL_FIELDS = frozenset(
    ("grad_l2", "grad_rms", "grad_zero_frac", "update_ratio", "moment_rms"))

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")

# Single constants table for every band in the observatory — inspector's
# GradientAudit defaults resolve from here too (satellite: the two
# subsystems can never disagree on what "vanishing" means).
THRESHOLDS: Dict[str, float] = {
    # per-step grad classification (shared with GradientAudit)
    "grad_vanishing_abs_mean": 1e-8,
    "grad_exploding_max_abs": 1e3,
    # time-series verdicts
    "dead_grad_rms": 1e-12,          # grad present but ~exactly zero
    "frozen_update_ratio": 1e-12,    # weights not moving despite live grads
    "exploding_update_floor": 1e-1,  # |dW|/|W| above this is always suspect
    "exploding_update_band": 8.0,    # ... or this multiple of the EWMA
    "saturating_fraction": 0.995,    # activation |mean| vs max-abs
    # window lengths (samples, not steps)
    "verdict_window": 8,
    "verdict_warmup": 2,
}

# Stable health codes. Every classification site goes through _code() so
# tools/check_registry.py can pin this catalog against the emit sites in
# both directions (a code emitted but not cataloged, or cataloged but never
# emitted, fails the lint).
HEALTH_CATALOG: Dict[str, str] = {
    "ok": "series within all bands",
    "dead-layer": "grad rms ~ 0 across the verdict window (no learning "
                  "signal reaches this layer)",
    "frozen-param": "update ratio ~ 0 across the verdict window while "
                    "grads are live (optimizer not applying them)",
    "exploding-update": "|dW|/|W| above the absolute floor or the EWMA "
                        "band (LR spike / divergence precursor)",
    "saturating": "activation |mean| pinned against max-abs (probe sites; "
                  "nonlinearity stuck in its flat region)",
    "nonfinite": "NaN/Inf values in the gradient",
    "zero": "gradient identically zero this step (or param detached)",
    "vanishing": "gradient |mean| below the vanishing band",
    "exploding": "gradient max-abs above the exploding band",
}

MAX_PARAM_SERIES = 32      # past this, series collapse to planner roles
RING_CAPACITY = 512        # samples kept per series
EWMA_ALPHA = 0.15          # matches sentinel.Baseline smoothing
DEFAULT_PERIOD = 16
_EPS = 1e-12


def _code(code: str) -> str:
    assert code in HEALTH_CATALOG, f"uncataloged health code {code!r}"
    return code


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------

_FORCE_ENABLED: Optional[bool] = None
_FORCE_PERIOD: Optional[int] = None


def enabled() -> bool:
    if _FORCE_ENABLED is not None:
        return _FORCE_ENABLED
    raw = flags.env("PADDLE_TPU_DYNAMICS")
    return raw is not None and raw.strip().lower() in ("1", "true", "on",
                                                       "yes")


def period() -> int:
    if _FORCE_PERIOD is not None:
        return _FORCE_PERIOD
    raw = os.environ.get("PADDLE_TPU_DYNAMICS_PERIOD", "").strip()
    try:
        p = int(raw) if raw else DEFAULT_PERIOD
    except ValueError:
        p = DEFAULT_PERIOD
    return max(p, 1)


class override:
    """Context manager forcing the observatory on/off (and optionally the
    period) regardless of the environment — the bench A/B arms and the
    parity test use this rather than mutating os.environ."""

    def __init__(self, enabled: Optional[bool], period: Optional[int] = None):
        self._enabled = enabled
        self._period = period
        self._saved: Tuple[Optional[bool], Optional[int]] = (None, None)

    def __enter__(self):
        global _FORCE_ENABLED, _FORCE_PERIOD
        self._saved = (_FORCE_ENABLED, _FORCE_PERIOD)
        _FORCE_ENABLED = self._enabled
        if self._period is not None:
            _FORCE_PERIOD = int(self._period)
        return self

    def __exit__(self, *exc):
        global _FORCE_ENABLED, _FORCE_PERIOD
        _FORCE_ENABLED, _FORCE_PERIOD = self._saved
        return False


def cache_token_of(dyn_plan: Optional["DynamicsPlan"]):
    """cache_token of a program whose plan is `dyn_plan` (None: off)."""
    return None if dyn_plan is None else (True, dyn_plan.period)


def cache_token(program) -> Optional[Tuple[bool, int]]:
    """Part of the executor's graph key: flipping the knob or the period
    captures anew (the step's outputs change)."""
    if not enabled() or plan(program) is None:
        return None
    return (True, period())


# ---------------------------------------------------------------------------
# Trace-time plan
# ---------------------------------------------------------------------------

class _ParamEntry:
    __slots__ = ("name", "grad", "sparse_grad", "moments", "role")

    def __init__(self, name, grad, sparse_grad, moments, role):
        self.name = name
        self.grad = grad
        self.sparse_grad = sparse_grad
        self.moments = moments
        self.role = role


class _Group:
    __slots__ = ("name", "role", "params")

    def __init__(self, name, role, params):
        self.name = name
        self.role = role
        self.params = params


class DynamicsPlan:
    __slots__ = ("groups", "grab_names", "period", "n_params")

    def __init__(self, groups, grab_names, period_, n_params):
        self.groups = groups
        self.grab_names = grab_names
        self.period = period_
        self.n_params = n_params


def _param_roles(program, params) -> Dict[str, str]:
    try:
        from .parallel.planner import classify_params
        roles = classify_params(program)
    except Exception:
        roles = {}
    return {p: roles.get(p, "dense") for p in params}


def _discover_moments(block, param_shapes) -> Dict[str, List[str]]:
    """Optimizer accumulators: inputs of any op with a Param slot whose
    persistable desc shape equals the param's (excludes the [1]-shaped
    global beta-pow accumulators)."""
    moments: Dict[str, List[str]] = {}
    for op in block.ops:
        pnames = op.desc.inputs.get("Param")
        if not pnames or pnames[0] not in param_shapes:
            continue
        pname = pnames[0]
        pshape = param_shapes[pname]
        for slot, names in op.desc.inputs.items():
            if slot in ("Param", "Grad", "LearningRate"):
                continue
            for n in names:
                if n == pname or not block.desc.has_var(n):
                    continue
                d = block.desc.var(n)
                if not d.persistable or d.shape is None:
                    continue
                if tuple(d.shape) != tuple(pshape):
                    continue
                if (d.dtype or "float32") not in _FLOAT_DTYPES:
                    continue
                bucket = moments.setdefault(pname, [])
                if n not in bucket:
                    bucket.append(n)
    return moments


def _build_plan(program) -> Optional[DynamicsPlan]:
    block = program.global_block()
    params = [p for p in block.all_parameters()
              if getattr(p, "trainable", True)
              and (p.dtype or "float32") in _FLOAT_DTYPES]
    if not params:
        return None

    written = set()
    for op in block.ops:
        written.update(op.output_arg_names)

    entries = []
    for p in params:
        g = grad_var_name(p.name)
        grad = None
        sparse = False
        if g in written and block.desc.has_var(g):
            d = block.desc.var(g)
            if (d.dtype or "float32") in _FLOAT_DTYPES:
                grad = g
                sparse = d.type == VarType.SELECTED_ROWS
        entries.append((p.name, grad, sparse, tuple(p.shape or ())))
    if not any(e[1] for e in entries):
        # no grads written anywhere: startup / serving / inference program
        return None

    param_shapes = {name: shape for name, _, _, shape in entries}
    moments = _discover_moments(block, param_shapes)
    roles = _param_roles(program, list(param_shapes))

    pents = [_ParamEntry(name, grad, sparse,
                         tuple(moments.get(name, ())), roles[name])
             for name, grad, sparse, _ in entries]

    if len(pents) <= MAX_PARAM_SERIES:
        groups = [_Group(e.name, e.role, [e]) for e in pents]
    else:
        by_role: Dict[str, List[_ParamEntry]] = {}
        for e in pents:
            by_role.setdefault(e.role, []).append(e)
        groups = [_Group(role, role, es)
                  for role, es in sorted(by_role.items())]
    groups.sort(key=lambda grp: grp.name)

    grab = sorted({e.grad for e in pents if e.grad is not None})
    return DynamicsPlan(groups, tuple(grab), period(), len(pents))


def plan(program) -> Optional[DynamicsPlan]:
    """Resolve (and cache on the program) the reduction plan, or None when
    dynamics is off / the program trains nothing / it is an inspector
    bisection clone."""
    if not enabled():
        return None
    if getattr(program, "_inspector_internal", False):
        return None
    key = (getattr(program, "_version", 0), period())
    cached = getattr(program, "_dynamics_plan", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    built = _build_plan(program)
    program._dynamics_plan = (key, built)
    return built


# ---------------------------------------------------------------------------
# The grouped reduction on the card (inside the executor's step)
# ---------------------------------------------------------------------------

def sampled(dyn_plan: Optional[DynamicsPlan], rng_counter: int) -> bool:
    """Whether the step of run counter `rng_counter` samples (the
    reference's `lax.cond` predicate, decided on the host)."""
    return dyn_plan is not None and int(rng_counter) % dyn_plan.period == 0


def _norms(ts: List[torch.Tensor], ord_) -> List[torch.Tensor]:
    """Per-tensor norms as f32 0-d tensors, one torch._foreach_norm per
    dtype among `ts` (the foreach kernels take one dtype a list)."""
    out: List[Optional[torch.Tensor]] = [None] * len(ts)
    by_dtype: Dict[Any, List[int]] = {}
    for i, t in enumerate(ts):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        ns = torch._foreach_norm([ts[i] for i in idx], ord_)
        for i, nrm in zip(idx, ns):
            out[i] = nrm.float()
    return out


def group_rows(dyn_plan: DynamicsPlan, old_state, new_state, grabs,
               const=None) -> torch.Tensor:
    """[len(groups), len(STAT_FIELDS)] float32: the reference's
    `_group_row` for every group (paddle_tpu/dynamics.py:324-391), in a
    bounded number of launches. `old_state` holds the step's state before
    it, `new_state` its persistable outputs, `grabs` the gradients by
    name (a SelectedRowsVal for a sparse one). `const(values, dtype)`
    makes a host array a device tensor (the executor's cached
    `constant`, so a CUDA graph's capture copies nothing from the host);
    None makes it afresh."""
    # one entry a (group, parameter): the tensors each field reduces
    gi: List[int] = []
    W, D_new, D_old, G, M = [], [], [], [], []
    d_of, g_of, m_of = [], [], []      # group of each D / G / M entry
    w_n = [0.0] * len(dyn_plan.groups)
    g_n = [0.0] * len(dyn_plan.groups)
    m_n = [0.0] * len(dyn_plan.groups)
    has_grad = [False] * len(dyn_plan.groups)
    has_update = [False] * len(dyn_plan.groups)
    has_moment = [False] * len(dyn_plan.groups)
    for k, grp in enumerate(dyn_plan.groups):
        for ent in grp.params:
            w_old = old_state.get(ent.name)
            if w_old is None:
                continue
            w_new = new_state.get(ent.name, w_old)
            gval = grabs.get(ent.grad) if ent.grad is not None else None
            rows = gval.rows.long() if isinstance(gval, SelectedRowsVal) \
                else None
            if rows is not None:
                # every statistic of a sparse-grad parameter reduces over
                # the rows this step touched, never the whole table
                wf = w_new.index_select(0, rows)
                of = w_old.index_select(0, rows)
            else:
                wf, of = w_new, w_old
            W.append(wf)
            gi.append(k)
            w_n[k] += float(wf.numel())
            if ent.name in new_state:
                has_update[k] = True
                D_new.append(wf)
                D_old.append(of)
                d_of.append(k)
            if gval is not None:
                gf = gval.values if rows is not None else gval
                has_grad[k] = True
                G.append(gf)
                g_of.append(k)
                g_n[k] += float(gf.numel())
            for mname in ent.moments:
                mval = new_state.get(mname, old_state.get(mname))
                if mval is None:
                    continue
                if rows is not None and tuple(mval.shape) == \
                        tuple(w_new.shape):
                    mval = mval.index_select(0, rows)
                has_moment[k] = True
                M.append(mval)
                m_of.append(k)
                m_n[k] += float(mval.numel())
    n_groups = len(dyn_plan.groups)
    dev = W[0].device if W else torch.device("cpu")
    if const is None:
        def const(values, dtype):
            return torch.as_tensor(np.asarray(values), device=dev).to(dtype)
    f32, f64 = torch.float32, torch.float64
    # per-entry sums added into their groups in f64: a group's nonzero
    # count passes 2^24 on a large model, where f32 counts round
    sums = torch.zeros((n_groups, 6), dtype=f64, device=dev)

    def add(col, vals, groups, square=True):
        if not vals:
            return
        v = torch.stack(vals).double()
        if square:
            v = v * v
        sums[:, col].index_add_(
            0, const(np.asarray(groups, np.int64), torch.int64), v)

    zero = torch.zeros((), dtype=f32, device=dev)
    w_max = [zero] * n_groups
    if W:
        add(0, _norms(W, 2.0), gi)                          # sum w^2
        wmax = torch.stack(_norms(W, float("inf")))
        # entries come group by group: each group's max over its slice
        # (amax keeps a NaN, as the reference's maximum does)
        for k in range(n_groups):
            a, b = gi.index(k) if k in gi else 0, len(gi) - gi[::-1].index(
                k) if k in gi else 0
            if b > a:
                w_max[k] = wmax[a:b].amax()
    w_max = torch.stack(w_max).double()
    if D_new:
        diffs = torch._foreach_sub([d.float() for d in D_new],
                                   [d.float() for d in D_old])
        add(1, _norms(diffs, 2.0), d_of)                    # sum dW^2
    if G:
        add(2, _norms(G, 2.0), g_of)                        # sum g^2
        add(3, _norms(torch._foreach_sign(G), 1.0), g_of,   # nonzero count
            square=False)
    if M:
        add(4, _norms(M, 2.0), m_of)                        # sum m^2
    absent = torch.full((n_groups,), -1.0, dtype=f64, device=dev)

    def mask(flags_):
        return const(np.asarray(flags_, np.bool_), torch.bool)

    def per(counts):
        return const(np.maximum(np.asarray(counts, np.float64), 1.0), f64)

    w_l2 = sums[:, 0].sqrt()
    cols = [
        w_l2,
        (sums[:, 0] / per(w_n)).sqrt(),
        w_max,
        torch.where(mask(has_grad), sums[:, 2].sqrt(), absent),
        torch.where(mask(has_grad), (sums[:, 2] / per(g_n)).sqrt(), absent),
        torch.where(mask(has_grad), 1.0 - sums[:, 3] / per(g_n), absent),
        torch.where(mask(has_update), sums[:, 1].sqrt() / (w_l2 + _EPS),
                    absent),
        torch.where(mask(has_moment), (sums[:, 4] / per(m_n)).sqrt(),
                    absent),
    ]
    return torch.stack(cols, dim=1).float()


def sampled_stats(dyn_plan: Optional[DynamicsPlan], old_state, new_state,
                  grabs, rng_counter, const=None):
    """[len(groups), len(STAT_FIELDS)] float32 on a sampled step, None on
    any other step or with no plan (the reference returns a NaN filler
    there, from inside its jitted step; the host here knows the
    counter)."""
    if not sampled(dyn_plan, rng_counter):
        return None
    return group_rows(dyn_plan, old_state, new_state, grabs, const)


# ---------------------------------------------------------------------------
# Per-step grad classification (shared with inspector.GradientAudit)
# ---------------------------------------------------------------------------

def classify_grad(nonfinite: bool, l2: float, abs_mean: float,
                  max_abs: float,
                  vanishing_threshold: Optional[float] = None,
                  exploding_threshold: Optional[float] = None) -> str:
    """The one grad-health decision procedure: GradientAudit delegates here
    so its verdicts and the observatory's use identical bands."""
    vt = (THRESHOLDS["grad_vanishing_abs_mean"]
          if vanishing_threshold is None else vanishing_threshold)
    et = (THRESHOLDS["grad_exploding_max_abs"]
          if exploding_threshold is None else exploding_threshold)
    if nonfinite:
        return _code("nonfinite")
    if l2 == 0.0:
        return _code("zero")
    if abs_mean < vt:
        return _code("vanishing")
    if max_abs > et:
        return _code("exploding")
    return _code("ok")


# ---------------------------------------------------------------------------
# Host-side observatory: rings, EWMA baselines, verdicts, export
# ---------------------------------------------------------------------------

class _Series:
    __slots__ = ("role", "ring", "ewma", "n", "code", "since_step")

    def __init__(self, role: str):
        self.role = role
        self.ring = collections.deque(maxlen=RING_CAPACITY)
        self.ewma: Dict[str, float] = {}
        self.n = 0
        self.code = _code("ok")
        self.since_step: Optional[int] = None


class _Observatory:
    def __init__(self):
        self.lock = threading.RLock()
        self.programs: Dict[str, Dict[str, _Series]] = {}
        self.activations: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self.samples = 0
        self._log_fh = None
        self._log_path: Optional[str] = None

    # -- JSONL export -------------------------------------------------------

    def _resolve_log_path(self) -> Optional[str]:
        explicit = os.environ.get("PADDLE_TPU_DYNAMICS_LOG", "").strip()
        if explicit:
            return explicit
        step_log = telemetry.step_log_path()
        if step_log:
            root, _ = os.path.splitext(step_log)
            return root + ".dynamics.jsonl"
        return None

    def _write_log(self, rec: Dict[str, Any]):
        path = self._resolve_log_path()
        if path is None:
            return
        try:
            if self._log_fh is None or self._log_path != path:
                if self._log_fh is not None:
                    self._log_fh.close()
                self._log_fh = open(path, "a", buffering=1)
                self._log_path = path
            self._log_fh.write(json.dumps(rec) + "\n")
        except OSError:
            self._log_fh = None
            self._log_path = None

    # -- classification -----------------------------------------------------

    def _classify(self, s: _Series, vals: Dict[str, Optional[float]]) -> str:
        present = [v for v in vals.values() if v is not None]
        if any(not math.isfinite(v) for v in present):
            return _code("nonfinite")
        win = int(THRESHOLDS["verdict_window"])
        hist = [h[1] for h in list(s.ring)[-(win - 1):]] + [vals]
        g = vals.get("grad_rms")
        u = vals.get("update_ratio")
        if g is not None and len(hist) >= win and all(
                h.get("grad_rms") is not None
                and h["grad_rms"] <= THRESHOLDS["dead_grad_rms"]
                for h in hist):
            return _code("dead-layer")
        if (u is not None and g is not None
                and g > THRESHOLDS["dead_grad_rms"]
                and len(hist) >= win and all(
                    h.get("update_ratio") is not None
                    and h["update_ratio"]
                    <= THRESHOLDS["frozen_update_ratio"]
                    for h in hist)):
            return _code("frozen-param")
        base = s.ewma.get("update_ratio")
        if (u is not None and base is not None
                and s.n >= THRESHOLDS["verdict_warmup"]
                and u > max(THRESHOLDS["exploding_update_floor"],
                            THRESHOLDS["exploding_update_band"] * base)):
            return _code("exploding-update")
        return _code("ok")

    # -- sample intake ------------------------------------------------------

    def record(self, prog_label: str, step: int, dyn_plan: DynamicsPlan,
               row_arr: np.ndarray):
        arr = np.asarray(row_arr, np.float64)
        log_recs = []
        with self.lock:
            series_map = self.programs.setdefault(prog_label, {})
            ts = time.time()
            for gi, grp in enumerate(dyn_plan.groups):
                vals: Dict[str, Optional[float]] = {}
                for fi, fname in enumerate(STAT_FIELDS):
                    v = float(arr[gi, fi])
                    if fname in _OPTIONAL_FIELDS and v < 0.0:
                        vals[fname] = None
                    else:
                        vals[fname] = v
                s = series_map.get(grp.name)
                if s is None:
                    s = series_map[grp.name] = _Series(grp.role)
                code = self._classify(s, vals)
                if code != s.code:
                    s.since_step = step
                s.code = code
                # score-before-absorb: the sample was judged against the
                # baseline it did not yet influence
                for fname, v in vals.items():
                    if v is None or not math.isfinite(v):
                        continue
                    prev = s.ewma.get(fname)
                    s.ewma[fname] = (v if prev is None else
                                     prev + EWMA_ALPHA * (v - prev))
                s.ring.append((step, vals))
                s.n += 1
                self._emit_series_gauges(prog_label, grp.name, vals)
                log_recs.append({
                    "ts": ts, "program": prog_label, "step": step,
                    "series": grp.name, "role": grp.role, "code": code,
                    **{k: (v if v is None or math.isfinite(v) else str(v))
                       for k, v in vals.items()}})
            self.samples += 1
            self._emit_program_gauges(prog_label, series_map)
        # JSONL export happens outside the observatory lock (file IO can
        # block); each record is one buffered write, so lines from
        # concurrent recorders interleave whole, never torn
        for rec in log_recs:
            self._write_log(rec)

    def _emit_series_gauges(self, prog_label, series, vals):
        u = vals.get("update_ratio")
        if u is not None and math.isfinite(u):
            telemetry.gauge(
                "dynamics_update_ratio",
                "per-series |dW|/(|W|+eps) from the fused on-device "
                "dynamics reduction",
                labels=("program", "series")).labels(
                    program=prog_label, series=series).set(u)
        g = vals.get("grad_rms")
        if g is not None and math.isfinite(g):
            telemetry.gauge(
                "dynamics_grad_rms",
                "per-series gradient RMS (dynamics observatory)",
                labels=("program", "series")).labels(
                    program=prog_label, series=series).set(g)
        w = vals.get("weight_rms")
        if w is not None and math.isfinite(w):
            telemetry.gauge(
                "dynamics_weight_rms",
                "per-series parameter RMS (dynamics observatory)",
                labels=("program", "series")).labels(
                    program=prog_label, series=series).set(w)

    def _emit_program_gauges(self, prog_label, series_map):
        dead = sum(1 for s in series_map.values()
                   if s.code == "dead-layer")
        frozen = sum(1 for s in series_map.values()
                     if s.code == "frozen-param")
        unhealthy = sum(1 for s in series_map.values() if s.code != "ok")
        # emitted every sample (including 0) so the sentinel baselines warm
        # up on healthy history instead of skipping an absent series
        telemetry.gauge(
            "dynamics_dead_layers",
            "series currently classified dead-layer",
            labels=("program",)).labels(program=prog_label).set(dead)
        telemetry.gauge(
            "dynamics_frozen_params",
            "series currently classified frozen-param",
            labels=("program",)).labels(program=prog_label).set(frozen)
        telemetry.gauge(
            "dynamics_unhealthy_series",
            "series with any non-ok dynamics verdict",
            labels=("program",)).labels(program=prog_label).set(unhealthy)
        telemetry.counter(
            "dynamics_samples_total",
            "dynamics samples recorded by the observatory",
            labels=("program",)).labels(program=prog_label).inc()

    # -- activation saturation (fed from inspector probes) ------------------

    def observe_probes(self, prog_label: str, stats):
        with self.lock:
            acts = self.activations.setdefault(prog_label, {})
            for site, st in stats.items():
                if getattr(site, "kind", None) != "probe":
                    continue
                try:
                    mx = max(abs(st.min), abs(st.max))
                    sat = (mx > 0 and st.size > 1 and st.abs_mean
                           >= THRESHOLDS["saturating_fraction"] * mx)
                    acts[site.var] = {
                        "code": _code("saturating") if sat else _code("ok"),
                        "abs_mean": st.abs_mean, "max_abs": mx,
                        "op_index": site.op_index}
                except Exception:
                    continue

    # -- read side ----------------------------------------------------------

    def verdicts(self) -> List[Dict[str, Any]]:
        out = []
        with self.lock:
            for prog, series_map in self.programs.items():
                for name, s in series_map.items():
                    if s.code != "ok":
                        out.append({"program": prog, "series": name,
                                    "role": s.role, "code": s.code,
                                    "since_step": s.since_step})
            for prog, acts in self.activations.items():
                for var, rec in acts.items():
                    if rec.get("code") != "ok":
                        out.append({"program": prog, "series": var,
                                    "role": "activation",
                                    "code": rec["code"],
                                    "since_step": None})
        return out

    def payload(self, recent: int = 32) -> Dict[str, Any]:
        with self.lock:
            programs = {}
            for prog, series_map in self.programs.items():
                series = {}
                for name, s in series_map.items():
                    rows = list(s.ring)[-max(recent, 0):]
                    last = rows[-1][1] if rows else {}
                    series[name] = {
                        "role": s.role, "verdict": s.code,
                        "since_step": s.since_step, "samples": s.n,
                        "baseline": dict(s.ewma), "last": last,
                        "recent": [{"step": st, **vals}
                                   for st, vals in rows]}
                programs[prog] = {
                    "series": series,
                    "activations": self.activations.get(prog, {})}
            return {"enabled": enabled(), "period": period(),
                    "fields": list(STAT_FIELDS),
                    "thresholds": dict(THRESHOLDS),
                    "health_codes": dict(HEALTH_CATALOG),
                    "samples_recorded": self.samples,
                    "programs": programs,
                    "verdicts": self.verdicts()}

    def crash_section(self) -> Optional[Dict[str, Any]]:
        with self.lock:
            if not self.programs and not self.activations:
                return None
            last = {}
            for prog, series_map in self.programs.items():
                last[prog] = {
                    name: {"verdict": s.code,
                           "last": (s.ring[-1][1] if s.ring else {}),
                           "step": (s.ring[-1][0] if s.ring else None)}
                    for name, s in series_map.items()}
            samples = self.samples
        return {"verdicts": self.verdicts(), "last": last,
                "samples_recorded": samples}


_OBS = _Observatory()


# ---------------------------------------------------------------------------
# Executor entry points
# ---------------------------------------------------------------------------

def _host(stats) -> np.ndarray:
    """A rows tensor (on the card) as a host array."""
    if isinstance(stats, torch.Tensor):
        return stats.detach().cpu().numpy()
    return np.asarray(stats)


def on_step(program, prog_label: str, stats, rng_counter: int):
    """Record the per-step stats array if this step was a sample (the
    executor passes the pre-increment counter the traced cond saw)."""
    dyn_plan = plan(program)
    if dyn_plan is None or stats is None:
        return
    if int(rng_counter) % dyn_plan.period != 0:
        return
    try:
        _OBS.record(prog_label, int(rng_counter), dyn_plan, _host(stats))
    except Exception:
        pass


def on_window(program, prog_label: str, stats, base_counter: int,
              steps: int):
    """Record the period-boundary rows out of a run_steps window's stacked
    [K, groups, fields] stats (step i ran with counter base_counter+i)."""
    dyn_plan = plan(program)
    if dyn_plan is None or stats is None:
        return
    try:
        arr = _host(stats)
        for i in range(int(steps)):
            c = int(base_counter) + i
            if c % dyn_plan.period == 0:
                _OBS.record(prog_label, c, dyn_plan, arr[i])
    except Exception:
        pass


def observe_probes(prog_label: str, stats):
    """Inspector hook: activation-probe stats feed `saturating` verdicts."""
    if not enabled():
        return
    try:
        _OBS.observe_probes(prog_label, stats)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Read side
# ---------------------------------------------------------------------------

def payload(recent: int = 32) -> Dict[str, Any]:
    """The reference's /dynamics endpoint body."""
    return _OBS.payload(recent=recent)


def verdicts() -> List[Dict[str, Any]]:
    return _OBS.verdicts()


def crash_section() -> Optional[Dict[str, Any]]:
    """Compact last-snapshot for inspector crash/hang reports."""
    return _OBS.crash_section()


def reset():
    """Drop all recorded history (tests)."""
    global _OBS
    with _OBS.lock:
        if _OBS._log_fh is not None:
            try:
                _OBS._log_fh.close()
            except OSError:
                pass
    _OBS = _Observatory()
