"""How far AMP O2 moves one ResNet-50 training step's gradients, in the JAX
package and in the port, from the same weights and batch, on the CPU.

Builds bench.py's `resnet` training program (build_image_classifier over
resnet50 at full depth and width, 1000 classes, Momentum 0.9) in both
packages, in f32 and under amp.decorate(level="O2"); runs the JAX startup,
carries its weights into the port by name, and takes one step in each of the
four runs on one seeded batch, fetching every trainable parameter's
gradient. The JAX O2 run reaches the Pallas conv kernels in interpret mode,
as the JAX package's own tests run them. For each pair of runs it prints
the loss's relative difference and, over the parameters, the relative L2
difference of the gradients and the ratio of their norms (min, median,
max). The JAX pair (O2 vs f32) says how far bf16 alone moves the reference;
the port's pair should move as far, and the port's O2 should sit no further
from the JAX O2.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_o2_spread.py
        [--size 64] [--batch 4] [--out PATH]

The image side is cut from 224 to keep the CPU's memory small (the final
stage then pools 2x2 at --size 64).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

SEED = 0
PAIRS = (("jax_o2", "jax_f32"), ("port_o2", "port_f32"),
         ("port_f32", "jax_f32"), ("port_o2", "jax_o2"))


def _build(fluid, resnet, size, amp):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, size, size],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        avg_cost, _, _ = fluid.models.build_image_classifier(
            resnet.resnet50, img, label, class_dim=1000)
        opt = fluid.optimizer.Momentum(learning_rate=0.0125, momentum=0.9)
        if amp:
            opt = fluid.amp.decorate(opt, level="O2")
        opt.minimize(avg_cost)
    main.random_seed = startup.random_seed = SEED + 1
    return main, startup, avg_cost


def _spread(a, b):
    (la, ga), (lb, gb) = a, b
    rl2 = [float(np.linalg.norm(x - y) / (np.linalg.norm(y) + 1e-30))
           for x, y in zip(ga, gb)]
    ratio = [float(np.linalg.norm(x) / (np.linalg.norm(y) + 1e-30))
             for x, y in zip(ga, gb)]
    return {"loss_rel_diff": abs(la - lb) / abs(lb),
            "grad_rl2_median": float(np.median(rl2)),
            "grad_rl2_max": max(rl2),
            "norm_ratio_min": min(ratio),
            "norm_ratio_median": float(np.median(ratio)),
            "norm_ratio_max": max(ratio)}


def measure(size: int, batch: int) -> dict:
    import paddle_tpu as jfluid
    from paddle_tpu import executor as jax_executor
    from paddle_tpu.models import resnet as jax_resnet
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet as port_resnet

    rng = np.random.default_rng(SEED)
    feed = {"img": rng.standard_normal((batch, 3, size, size)).astype(np.float32),
            "label": rng.integers(0, 1000, (batch, 1)).astype(np.int64)}
    _, startup, _ = _build(jfluid, jax_resnet, size, False)
    scope = jax_executor.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    init = {n: np.array(scope.find_var(n)).astype(np.float32)
            for n, v in startup.global_block().desc.vars.items() if v.persistable}
    params = sorted(p.name for p in startup.global_block().all_parameters()
                    if p.trainable)
    fetch = [p + "@GRAD" for p in params]

    runs = {}
    for key, fluid, resnet, amp in (
            ("jax_f32", jfluid, jax_resnet, False),
            ("jax_o2", jfluid, jax_resnet, True),
            ("port_f32", pt, port_resnet, False),
            ("port_o2", pt, port_resnet, True)):
        t0 = time.perf_counter()
        main, _, loss = _build(fluid, resnet, size, amp)
        if fluid is jfluid:
            sc = jax_executor.Scope()
            for n, a in init.items():
                sc.set_var(n, a)
            exe = jfluid.Executor(jfluid.CPUPlace())
        else:
            sc = pt.Scope()
            pt.interop.load_numpy_params(sc, init, "cpu")
            exe = pt.Executor(pt.CPUPlace())
        out = exe.run(main, feed=feed, fetch_list=[loss] + fetch, scope=sc)
        runs[key] = (float(np.ravel(out[0])[0]),
                     [np.asarray(g, dtype=np.float32) for g in out[1:]])
        print(f"{key}: loss {runs[key][0]:.6f}, {time.perf_counter() - t0:.1f} s",
              flush=True)
    result = {"size": size, "batch": batch, "params": len(params),
              "losses": {k: v[0] for k, v in runs.items()}}
    for a, b in PAIRS:
        r = result[f"{a}_vs_{b}"] = _spread(runs[a], runs[b])
        print(f"{a} vs {b}: loss {r['loss_rel_diff']:.3g} relative; grad "
              f"relative L2 median {r['grad_rl2_median']:.3g}, max "
              f"{r['grad_rl2_max']:.3g}; norm ratio min "
              f"{r['norm_ratio_min']:.3g}, median {r['norm_ratio_median']:.3g}, "
              f"max {r['norm_ratio_max']:.3g}", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=64, help="image side")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", help="also write the numbers as JSON here")
    args = ap.parse_args(argv)
    result = measure(args.size, args.batch)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
