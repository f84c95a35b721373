"""Times host-bound paths of a checkout on the card, as chip_smoke.py
builds them (random weights from its seed). `--paths resnet` (default):
the batch-16 AMP O2 ResNet-50 request through ServingEngine and the
batch-32 AMP O2 training step through Executor.run. `--paths f32_lm`: the
transformer LM's f32 training step (no AMP) at batch 1, T 2048, and the
same model's f32 ring step (one-rank 'sp' mesh, T 2048), each with one
profiled step's device busy time. For comparing two trees in one call,
run it once per tree, in turns (parent, change, change, parent): on a
shared host the host clock drifts between minutes, and only runs made
close together compare.

    python tests/torch_ab_steps.py --root PATH [--paths resnet|f32_lm]
        [--requests 20] [--steps 10]

`--root` is the checkout whose paddle_tpu_torch/ and chip_smoke.py are
timed (default: this one). Prints one JSON line: the root, the card, and
per path the p50 in ms over the timed calls after one warm-up (f32_lm:
and the busy ms).
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
    ap.add_argument("--paths", default="resnet", choices=("resnet", "f32_lm"))
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


if __name__ == "__main__":
    sys.exit(main())
