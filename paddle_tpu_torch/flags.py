"""Central flag registry (the port's counterpart of paddle_tpu/flags.py;
reference: paddle/utils/Flags.cpp's gflags and the fluid DEFINE_* flags,
forwarded via core.init_gflags). Flags are declared here with defaults and
help, read from `PADDLE_TPU_<NAME>` environment variables, and queryable at
runtime:

    from paddle_tpu_torch import flags
    flags.get("allow_zero_grad")        # -> bool
    flags.set("allow_zero_grad", True)  # writes the env var
    flags.dump()                      # -> {name: (value, help)}

Modules that read their flag at import time act on the value `snapshot()`
returns (the executor's `eager`, `trap_fp`, `benchmark` and `record_ops`,
as the JAX package reads them at import; `step_log` is telemetry's
PADDLE_TPU_STEP_LOG, read when it imports); the live ones re-read `get()`
at every use (`allow_zero_grad` in append_backward, `vlog` in
executor.vlog, `check_nan_inf` (and its import-time value) and
`nonfinite_attribution` in Executor.run, `flight_recorder` in
inspector.flight_enabled, `max_loop_iters`, `telemetry_fetch`, and
memory's `memory_analysis`, `memory_tracker` and `hbm_budget_bytes`,
defined in memory.py). The catalogue is the JAX package's less
`test_platform` and `xla_cache`, the JAX test suite's platform and XLA
compilation cache, which mean nothing here.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

_REGISTRY: Dict[str, Tuple[Any, type, str]] = {}
# name -> its PADDLE_TPU_<NAME> variable, encoded as os.environ keeps it:
# get() is on the executor's per-run path, where os.environ.get (which
# encodes the key anew each call) cost more than the rest of a read
_ENV: Dict[str, Any] = {}
_DATA = getattr(os.environ, "_data", None)


def env(var: str):
    """os.environ.get(var), read through os.environ's own mapping with the
    key encoded once (os.environ's other mappings and its putenv calls go
    through the same mapping, so the value is the live one)."""
    if _DATA is None:
        return os.environ.get(var)
    key = _KEYS.get(var)
    if key is None:
        key = _KEYS[var] = os.environ.encodekey(var)
    raw = _DATA.get(key)
    return None if raw is None else os.environ.decodevalue(raw)


_KEYS: Dict[str, Any] = {}
# the value seen when the flag was defined: modules that read their
# PADDLE_TPU_* variable at import time act on this one
_IMPORT_SNAPSHOT: Dict[str, Any] = {}


def define(name: str, default, help_str: str, type_=None):
    t = type_ or type(default)
    _REGISTRY[name] = (default, t, help_str)
    _ENV[name] = f"PADDLE_TPU_{name.upper()}"
    _IMPORT_SNAPSHOT[name] = get(name)
    return _IMPORT_SNAPSHOT[name]


def _parse(raw: str, t: type, default):
    # as the modules read their variables: a bool flag is on only for "1";
    # a numeric flag set to "" takes its default
    if t is bool:
        return raw == "1"
    if raw == "":
        return default
    return t(raw)


def get(name: str):
    """The environment's value now (the default when unset)."""
    raw = env(_ENV[name])
    if raw is None:
        return _REGISTRY[name][0]
    default, t, _ = _REGISTRY[name]
    return _parse(raw, t, default)


def set(name: str, value):
    """Set a flag by writing its `PADDLE_TPU_<NAME>` variable (child
    processes inherit it). `value=None` unsets it, restoring the default.
    Returns the new effective value."""
    default, t, _ = _REGISTRY[name]
    env = f"PADDLE_TPU_{name.upper()}"
    if value is None:
        os.environ.pop(env, None)
        return default
    if t is bool:
        raw = "1" if value not in (False, 0, "0", "") else "0"
    else:
        raw = str(t(value))
    os.environ[env] = raw
    return get(name)


def snapshot(name: str):
    """The value when the flag was defined."""
    return _IMPORT_SNAPSHOT[name]


def dump() -> Dict[str, Tuple[Any, str]]:
    """{name: (value, help)}; where the environment changed since the
    snapshot, the help says so."""
    out = {}
    for n, (_, _, h) in sorted(_REGISTRY.items()):
        cur = get(n)
        if cur != _IMPORT_SNAPSHOT.get(n, cur):
            h = (f"{h} [env changed after import: active="
                 f"{_IMPORT_SNAPSHOT[n]!r}, env={cur!r}]")
        out[n] = (cur, h)
    return out


# --- the catalogue (reference Flags.cpp / executor.cc DEFINE_bool etc.) ----
define("eager", False,
       "op-by-op interpretation instead of graphed steps where the caller "
       "leaves use_jit unset; read at import "
       "(reference executor.cc interpreter semantics; debugging)")
define("check_nan_inf", False,
       "scan op outputs for NaN/Inf each step "
       "(reference FLAGS_check_nan_inf, executor.cc:325): a per-op scan in "
       "eager runs, one finiteness flag inside a graphed step")
define("trap_fp", False,
       "raise at the op producing NaN/Inf: every run eager with the per-op "
       "finite scan (reference TrainerMain.cpp:49 feenableexcept); read at "
       "import")
define("benchmark", False,
       "eager mode: wait for device completion after every op and log "
       "per-op wall time (reference FLAGS_benchmark, executor.cc:321); "
       "read at import")
define("allow_zero_grad", False,
       "permit NO_GRAD ops with differentiable inputs on the loss path "
       "instead of raising (append_backward safety check)")
define("vlog", 0,
       "verbose logging level; >0 enables vlog output "
       "(reference glog VLOG levels)")
define("record_ops", "",
       "file path: append every executed op type; read at import")
define("max_loop_iters", 128,
       "default while-loop step-scope recording capacity "
       "(While(max_iters=...) overrides per loop)")
define("nonfinite_attribution", True,
       "on NaN/Inf detection, replay the step with bisection probes to "
       "name the first offending op; live-read, 0 disables the extra "
       "replay runs")
define("flight_recorder", "",
       "path: enable the flight recorder; a JSON crash report is written "
       "there on executor exception or fatal signal")
define("step_log", "",
       "JSONL step-event log path (telemetry.enable_step_log); read at "
       "import")
define("telemetry_fetch", True,
       "fetch program._telemetry_fetch_extra side-outputs (e.g. the clip "
       "pass's global norm) alongside user fetches; 0 skips the per-step "
       "device->host read for latency-critical loops")
