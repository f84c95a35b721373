"""What a DLRM step's memory copies look like to the profiler on the card
(chip_smoke._memcpy_bytes): bench.py's DLRM at chip_smoke.DLRM's rows and
at DLRM_BIG_ROWS, each graphed step profiled TRIES times, every copy
listed by direction and bytes with the runtime call that issued it
(cudaMemcpyAsync from a CPU op, or cudaGraphLaunch for a graph's copy
node). With --profile-first the profiler runs once before any graph is
captured; without it the first height's graph is captured before the
profiler ever ran. python tests/torch_dlrm_copies_probe.py
[--profile-first] (~30 s on an H100)."""

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TRIES = 2


def _copies(cs, fn):
    with cs._profiled() as prof:
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    calls = {e["args"].get("correlation"): e["name"] for e in events
             if e.get("cat") == "cuda_runtime"}
    return [(e["name"].split()[1], e["args"]["bytes"],
             calls.get(e["args"].get("correlation")))
            for e in events if e.get("cat") == "gpu_memcpy"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-first", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import chip_smoke as cs
    import paddle_tpu_torch as pt
    print(cs._card_line(), flush=True)
    if args.profile_first:
        with cs._profiled():
            torch.ones(1, device="cuda").add_(1)
    c = cs.DLRM
    feed = cs._dlrm_batch(np.random.default_rng(cs.SEED + 21), c["rows"],
                          c["batch"])
    for rows in (c["rows"], cs.DLRM_BIG_ROWS):
        main, startup, loss = cs._dlrm_train(pt, rows)
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        for _ in range(3):              # warm-up, capture, replay
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        for t in range(TRIES):
            got = _copies(cs, lambda: exe.run(main, feed=feed,
                                              fetch_list=[loss], scope=scope))
            print(f"{rows} rows, graphed step, try {t}: {len(got)} copies, "
                  f"{sum(b for _, b, _ in got)} bytes, of them graph nodes "
                  f"{sum(1 for *_, k in got if k == 'cudaGraphLaunch')}",
                  flush=True)
        del exe, scope, main, startup
        cs._settled_reserved()
    return 0


if __name__ == "__main__":
    sys.exit(main())
