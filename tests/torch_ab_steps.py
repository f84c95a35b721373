"""Times host-bound paths of a checkout on the card, as chip_smoke.py
builds them (random weights from its seed). `--paths resnet` (default):
the batch-16 AMP O2 ResNet-50 request through ServingEngine and the
batch-32 AMP O2 training step through Executor.run. `--paths f32_lm`: the
transformer LM's f32 training step (no AMP) at batch 1, T 2048, and the
same model's f32 ring step (one-rank 'sp' mesh, T 2048), each with one
profiled step's device busy time. `--paths feeder`: chip_smoke.py's
train_feeder model (ResNet-50 O2, 102 classes, batch 32) three ways, in
turns (repeated, fed, window, window, fed, repeated): per-step run() on one
batch staged on the card once; per-step run() fed by a
DoubleBufferedFeeder over the flowers chain; run_steps(K=4) fed by a
DoubleBufferedFeeder with window_prefetch 2 (per-step time = window time /
4); each with one profiled step's (or window's) device busy ms per step.
`--paths graph`: chip_smoke.py's four graphed training paths (ResNet-50
O2 at batch 32, the LM O2 at batch 8 x T 2048, the f32 LM at batch 1, the
ring LM at T 32768), each from one startup state on two scopes, the
CUDA-graph step (Executor.run's default on the card) and the eager step
(use_jit=False) in turns (graph, eager, eager, graph, ...), each with one
profiled step's device busy ms; this tree only (an older tree has no
graphs: its eager step is `--paths resnet` or `f32_lm` there).
`--paths smallnet`: bench.py's SmallNet (32x32, 10 classes) AMP O2 at
batch 8, graphed, fed from the card and fetching the loss (the
host-bound graphed step), `--steps` blocks of 50 steps, each block's ms
a step; run it for two trees in turns to compare their host paths.
`--paths q8`: chip_smoke.py's AMP O3 training paths (ResNet-50 int8 at
batch 32, the LM int8 and fp8 at batch 8 x T 2048), each graphed beside
its O2 twin from one startup state, in turns (O3, O2, O2, O3, ...), each
with one profiled step's device busy ms and the peak memory of a step.
For comparing two trees in one call,
run it once per tree, in turns (parent, change, change, parent): on a
shared host the host clock drifts between minutes, and only runs made
close together compare.

    python tests/torch_ab_steps.py --root PATH [--paths resnet|f32_lm|feeder|graph|q8]
        [--requests 20] [--steps 10]

`--root` is the checkout whose paddle_tpu_torch/ and chip_smoke.py are
timed (default: this one). Prints one JSON line: the root, the card, and
per path the p50 in ms over the timed calls after one warm-up (f32_lm,
feeder, graph and q8: and the busy ms; q8: and the peak memory).
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--paths", default="resnet",
                    choices=("resnet", "f32_lm", "feeder", "graph", "q8",
                             "smallnet"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_ab_steps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import cuda_build
    from paddle_tpu_torch.serving import ServingEngine
    cuda_build.build()
    rng = np.random.default_rng(cs.SEED)
    if args.paths == "feeder":
        print(json.dumps({"root": args.root, "card": cs._card_line(),
                          **_feeder_steps(cs, pt, resnet, args.steps)}))
        return 0
    if args.paths == "graph":
        print(json.dumps({"root": args.root, "card": cs._card_line(),
                          **_graph_steps(cs, pt, resnet, args.steps)}))
        return 0
    if args.paths == "q8":
        print(json.dumps({"root": args.root, "card": cs._card_line(),
                          **_q8_steps(cs, pt, resnet, args.steps)}))
        return 0
    if args.paths == "smallnet":
        print(json.dumps({"root": args.root, "card": cs._card_line(),
                          **_smallnet_steps(cs, pt, args.steps)}))
        return 0
    if args.paths == "f32_lm":
        print(json.dumps({"root": args.root, "card": cs._card_line(),
                          **_f32_lm_steps(cs, pt, rng, args.steps)}))
        return 0

    main, startup, prob, _ = cs._resnet50(pt, resnet)
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    engine = ServingEngine(main, ["img"], [prob], buckets=(cs.BATCH,),
                           scope=scope)
    img = rng.standard_normal((cs.BATCH, 3, 224, 224)).astype(np.float32)
    engine.infer({"img": img})
    lat = []
    for _ in range(args.requests):
        t0 = time.perf_counter()
        engine.infer({"img": img})            # ends in a device->host copy
        lat.append((time.perf_counter() - t0) * 1e3)
    del engine, scope

    main, startup, loss = cs._resnet50_train(pt, resnet)
    scope = pt.Scope()
    exe = pt.Executor()
    exe.run(startup, scope=scope)
    feed = {"img": rng.standard_normal((cs.TRAIN_BATCH, 3, 224, 224))
            .astype(np.float32),
            "label": rng.integers(0, 1000, (cs.TRAIN_BATCH, 1)).astype(np.int64)}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    steps = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        steps.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"root": args.root, "card": cs._card_line(),
                      "request_p50_ms": float(np.median(lat)),
                      "request_ms": lat, "step_p50_ms": float(np.median(steps)),
                      "step_ms": steps}))
    return 0


def _smallnet_steps(cs, pt, blocks, batch=8, per_block=50):
    """SmallNet's graphed training step at `batch`: {the median block's ms
    a step, each block's}."""
    import numpy as np
    import torch
    zc = cs.ZOO["smallnet"]
    main, startup, loss = cs.zoo_train_net(pt, zc)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    feed = {n: torch.as_tensor(v, device=exe.device)
            for n, v in cs._zoo_feed(zc, batch, cs.SEED + 51).items()}
    for _ in range(3):                  # warm-up, capture, replay
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    ms = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(per_block):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / per_block)
    return {"smallnet_batch": batch, "step_p50_ms": float(np.median(ms)),
            "block_ms": ms}


def _f32_lm_steps(cs, pt, rng, steps):
    """chip_smoke.py's f32 LM step (batch 1, T 2048) and f32 ring step:
    {path: step p50 ms, the steps' ms, one profiled step's device busy
    ms}."""
    import numpy as np
    out = {}
    for name, kw in (("lm", {}),
                     ("ring", {"use_flash": True, "cfg": cs.RING,
                               "seqlen": cs.RING_SMALL_T,
                               "sequence_parallel": True})):
        main, startup, loss, _ = cs._transformer(pt, amp=False, **kw)
        scope = pt.Scope()
        exe = pt.Executor()
        exe.run(startup, scope=scope)
        vocab = kw.get("cfg", cs.LM)["vocab"]
        t = cs.LM["seqlen"]
        feed = {k: rng.integers(0, vocab, (1, t)).astype(np.int64)
                for k in ("tok", "lab")}
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            ms.append((time.perf_counter() - t0) * 1e3)
        p50 = float(np.median(ms))
        prof = cs._profile_step(exe, main, feed, loss, scope, p50,
                                cs._card_line(), ("a kernel", lambda n: True))
        out[name] = {"step_p50_ms": p50, "step_ms": ms,
                     "busy_ms": prof["busy_ms"]}
    return out


def _graph_steps(cs, pt, resnet, steps):
    """chip_smoke.py's graphed training paths, the graphed and the eager
    step in turns from one startup state: {path: {mode: step p50 ms, the
    steps' ms, one profiled step's device busy ms}}."""
    import numpy as np
    import torch
    out = {}
    card = cs._card_line()
    for name, (main, startup, loss), feed, _, witness in \
            cs._graph_paths(pt, resnet):
        exe = pt.Executor()
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        init = {n: v for n, v in scope.vars.items()
                if isinstance(v, torch.Tensor)}
        scopes = {"graph": cs._scope_from(pt, init),
                  "eager": cs._scope_from(pt, init)}
        use_jit = {"graph": None, "eager": False}
        del scope, init
        for mode in ("graph", "graph", "eager"):   # warm-up and capture
            exe.run(main, feed=feed, fetch_list=[loss], scope=scopes[mode],
                    use_jit=use_jit[mode])
        ms = {"graph": [], "eager": []}
        for i in range(steps):
            for mode in (("graph", "eager") if i % 2 == 0
                         else ("eager", "graph")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()       # ends in a device->host copy
                exe.run(main, feed=feed, fetch_list=[loss],
                        scope=scopes[mode], use_jit=use_jit[mode])
                ms[mode].append((time.perf_counter() - t0) * 1e3)
        out[name] = {}
        for mode, vals in ms.items():
            p50 = float(np.median(vals))
            busy = cs._profile_step(exe, main, feed, loss, scopes[mode], p50,
                                    card, witness,
                                    use_jit=use_jit[mode])["busy_ms"]
            out[name][mode] = {"step_p50_ms": p50, "step_ms": vals,
                               "busy_ms": busy}
        del exe, scopes
        torch.cuda.empty_cache()
    return out


def _q8_steps(cs, pt, resnet, steps):
    """chip_smoke.py's O3 training paths, the graphed O3 step and its
    graphed O2 twin in turns from one startup state: {path: {level: step
    p50 ms, the steps' ms, one profiled step's device busy ms, the peak
    memory a replay allocates beyond what it found}}."""
    import numpy as np
    import torch
    out = {}
    card = cs._card_line()
    for name, o3, o2, feed, _, _, _, witness in cs._q3_paths(pt, resnet):
        scope = pt.Scope()
        pt.Executor().run(o3[1], scope=scope)
        init = {n: v for n, v in scope.vars.items()
                if isinstance(v, torch.Tensor)}
        runs = {lvl: (pt.Executor(), prog, loss, cs._scope_from(pt, init))
                for lvl, (prog, _, loss) in (("o3", o3), ("o2", o2))}
        del scope, init
        for exe, prog, loss, sc in runs.values():   # warm-up and capture
            for _ in range(2):
                exe.run(prog, feed=feed, fetch_list=[loss], scope=sc)
        ms = {"o3": [], "o2": []}
        for i in range(steps):
            for lvl in (("o3", "o2") if i % 2 == 0 else ("o2", "o3")):
                exe, prog, loss, sc = runs[lvl]
                torch.cuda.synchronize()
                t0 = time.perf_counter()       # ends in a device->host copy
                exe.run(prog, feed=feed, fetch_list=[loss], scope=sc)
                ms[lvl].append((time.perf_counter() - t0) * 1e3)
        out[name] = {}
        for lvl, (exe, prog, loss, sc) in runs.items():
            p50 = float(np.median(ms[lvl]))
            busy = cs._profile_step(exe, prog, feed, loss, sc, p50, card,
                                    witness if lvl == "o3" else
                                    ("a kernel", lambda n: True))["busy_ms"]
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            exe.run(prog, feed=feed, fetch_list=[loss], scope=sc)
            torch.cuda.synchronize()
            out[name][lvl] = {"step_p50_ms": p50, "step_ms": ms[lvl],
                              "busy_ms": busy, "replay_peak_gb": (
                                  torch.cuda.max_memory_allocated()
                                  - before) / 1e9}
        del runs
        torch.cuda.empty_cache()
    return out


def _feeder_steps(cs, pt, resnet, steps):
    """The three ways of feeding chip_smoke.py's train_feeder model, timed in
    turns: {way: per-step p50 ms, the per-step ms, one profiled step's (a
    window's, per step) device busy ms}."""
    import numpy as np
    import torch
    from paddle_tpu_torch.reader.pipeline import DoubleBufferedFeeder
    main, startup, loss = cs._resnet50_train(pt, resnet,
                                             class_dim=cs.FEED_CLASSES)
    scope = pt.Scope()
    exe = pt.Executor()
    exe.run(startup, scope=scope)
    block = main.global_block()
    feeder = pt.DataFeeder([block.var("img"), block.var("label")], exe.place,
                           program=main)
    chain = cs._feeder_chain(pt)
    staged = {n: torch.as_tensor(v).cuda() for n, v in
              feeder.feed(next(iter(chain()))).items()}
    batches = DoubleBufferedFeeder(chain, to_feed=feeder.feed,
                                   capacity=cs.FEED_CAPACITY)
    windows = DoubleBufferedFeeder(chain, to_feed=feeder.feed,
                                   capacity=cs.FEED_CAPACITY,
                                   window_prefetch=cs.FEED_PREFETCH)
    it = iter(batches)

    def next_batch():
        nonlocal it
        try:
            return next(it)
        except StopIteration:          # a new pass
            it = iter(batches)
            return next(it)

    def run_repeated():
        t0 = time.perf_counter()
        exe.run(main, feed=staged, fetch_list=[loss], scope=scope)
        return [(time.perf_counter() - t0) * 1e3]

    def run_fed():
        feed = next_batch()
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        return [(time.perf_counter() - t0) * 1e3]

    def run_window():
        t0 = time.perf_counter()
        try:
            exe.run_steps(main, reader=windows, steps=cs.FEED_K,
                          fetch_list=[loss], scope=scope)
        except StopIteration:          # a new pass
            return []
        return [(time.perf_counter() - t0) * 1e3 / cs.FEED_K] * cs.FEED_K

    ways = {"repeated_run": run_repeated, "fed_run": run_fed,
            "fed_run_steps": run_window}
    ms = {w: [] for w in ways}
    for fn in ways.values():            # warm-up (the shuffle buffers fill)
        while not fn():
            pass
    for way in ("repeated_run", "fed_run", "fed_run_steps", "fed_run_steps",
                "fed_run", "repeated_run"):
        got = []
        while len(got) < steps:
            got += ways[way]()
        ms[way] += got
    card = cs._card_line()
    out = {}
    for way, vals in ms.items():
        p50 = float(np.median(vals))
        if way == "fed_run_steps":
            while True:
                try:
                    busy = cs._profile_window(exe, main, windows, loss, scope,
                                              card)["busy_ms"] / cs.FEED_K
                    break
                except StopIteration:  # a new pass
                    continue
        else:
            feed = staged if way == "repeated_run" else next_batch()
            busy = cs._profile_step(exe, main, feed, loss, scope, p50, card, (
                "K4", lambda n: cs.K1_KERNEL in n and "true" in n))["busy_ms"]
        out[way] = {"step_p50_ms": p50, "step_ms": vals,
                    "busy_ms_per_step": busy}
    batches.stop()
    windows.stop()
    return out


if __name__ == "__main__":
    sys.exit(main())
