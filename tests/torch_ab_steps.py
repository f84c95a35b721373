"""Times the two host-bound ResNet-50 paths of a checkout on the card: the
batch-16 AMP O2 request through ServingEngine and the batch-32 AMP O2
training step through Executor.run, as chip_smoke.py builds them (random
weights from its seed). For comparing two trees in one call, run it once
per tree, in turns (parent, change, change, parent): on a shared host the
host clock drifts between minutes, and only runs made close together
compare.

    python tests/torch_ab_steps.py --root PATH [--requests 20] [--steps 10]

`--root` is the checkout whose paddle_tpu_torch/ and chip_smoke.py are
timed (default: this one). Prints one JSON line: the root, the card, the
request p50 and the step p50 in ms, each over the timed calls after one
warm-up.
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


if __name__ == "__main__":
    sys.exit(main())
