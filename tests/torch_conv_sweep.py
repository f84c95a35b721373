"""Times K1's, K11's and K3's plans against their alternatives on the card,
at every ResNet-50 conv shape: the measurements behind `conv_cuda.conv_plan`'s
rules (bf16 and int8) and `conv_cuda._WGRAD_BLOCKS` (K3's split).

K1, at each served bucket's batch (1, 4, 16): per shape the plan's time and
the times with the other N tile, with the reduction split 1, 2, 4 or 8
ways, and with a ring of 2, 3 or 4 stages, each beside F.conv2d and the
bound; then the totals over one request's convs. K11 (`q8`), at the same
batches and every conv of ResNet-50's O3 route: the same alternatives of
its own plan, K1's time in bf16 at the shape and the bound, with `--parent
DIR` also the int8 kernel of an older checkout (DIR's
`paddle_tpu_torch/csrc/conv2d_q8.cu`, built from DIR's sources and held
bitwise to this tree's output), each shape's alternatives timed in turns
in one process. K3, at the training batch
(32): per shape the time of every split count from 1 to 256 (each split at
least one slice) with the plan's ring depth and with 3 stages, the best
one, the plan's, cuDNN's wgrad and the bound.
Every time is chip_smoke._device_ms's: a CUDA graph of 20 calls between
CUDA events. Needs one CUDA card and imports no JAX; run from the root of
a checkout:

    python tests/torch_conv_sweep.py [k1] [q8] [k3] [--parent DIR]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def _variants(plan):
    """name -> the plan with one choice changed (None where it is the same
    plan or cannot run)."""
    def split(k):
        per = -(-plan.steps // k)
        return dataclasses.replace(plan, splits=-(-plan.steps // per), per=per,
                                   stages=min(plan.stages, per))
    out = {"plan": plan,
           "other_n_tile": dataclasses.replace(
               plan, block_n=192 - plan.block_n)}
    for k in (1, 2, 4, 8):
        out[f"split{k}"] = split(k)
    for st in (2, 3, 4):
        out[f"stages{st}"] = dataclasses.replace(plan, stages=min(st, plan.per))
    return out


def sweep_k1(pt, conv_cuda, resnet, batch, say):
    import torch
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(cs.SEED)
    main = cs._resnet50(pt, resnet)[0]
    counts = {}
    for key in cs._eligible_convs(conv_cuda, main, batch):
        counts[key] = counts.get(key, 0) + 1
    totals = {}
    planner = conv_cuda.conv_plan
    for (xs, ws, s, p, d), n in counts.items():
        x = torch.randn(xs, generator=gen).to(torch.bfloat16).cuda()
        w = (torch.randn(ws, generator=gen) * 0.1).to(torch.bfloat16).cuda() \
            .contiguous(memory_format=torch.channels_last)
        oh, ow = conv_cuda._out_hw(x, w, s, p, d)
        plan = planner(xs, ws[0], ws[2], ws[3], oh, ow, s, p)
        times = {}
        for name, alt in _variants(plan).items():
            if alt.block_n < 64 or (name != "plan" and alt == plan) or \
                    (alt.block_n == 128 and ws[0] <= 64):
                continue
            conv_cuda.conv_plan = lambda *a, _alt=alt, **k: _alt
            try:
                times[name] = cs._device_ms(lambda: conv_cuda.conv2d(x, w, s, p, d))
            finally:
                conv_cuda.conv_plan = planner
        times["F.conv2d"] = cs._device_ms(lambda: F.conv2d(
            x.permute(0, 3, 1, 2), w, stride=s, padding=p, dilation=d))
        bound = max(conv_cuda.conv_flops(x, w, s, p, d) / cs.PEAK_BF16_FLOPS,
                    conv_cuda.conv_bytes(x, w, s, p, d) / cs.PEAK_BYTES) * 1e3
        for k, v in times.items():
            totals[k] = totals.get(k, 0.0) + v * n
        say(f"K1 b{batch} x{list(xs)} w{list(ws)} s{list(s)} x{n} plan("
            f"{'flat' if plan.flat else f'box {plan.lbn}{plan.lbh}{plan.lbw}'}"
            f" n{plan.block_n} tiles {plan.tiles} split {plan.splits} stages "
            f"{plan.stages}) bound {bound:.4f}: "
            + " ".join(f"{k} {v:.4f}" for k, v in times.items()))
    say(f"K1 b{batch} per request (ms): "
        + " ".join(f"{k} {v:.4f}" for k, v in totals.items()))


def sweep_q8(pt, conv_cuda, resnet, batch, say, parent=None):
    """K11's plan against its alternatives at every quantized ResNet-50
    conv of one bucket's batch, beside K1 in bf16 (the aim), the bound and
    (given) the parent tree's kernel."""
    import torch
    from paddle_tpu_torch import quant
    gen = torch.Generator().manual_seed(cs.SEED + 7)
    main = cs._resnet50(pt, resnet)[0]
    counts = {}
    for key in cs._eligible_convs(conv_cuda, main, batch, quant):
        counts[key] = counts.get(key, 0) + 1
    totals = {}
    planner = conv_cuda.conv_plan
    for (xs, ws, s, p, d), n in counts.items():
        x = torch.randint(-127, 128, xs, generator=gen, dtype=torch.int8).cuda()
        wt = torch.randint(-127, 128, ws, generator=gen, dtype=torch.int8)
        w = wt.cuda().permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
        dq = (torch.rand(ws[0], generator=gen) * 1e-4 + 1e-6).cuda()
        oh, ow = conv_cuda._out_hw(x, w, s, p, d)
        plan = planner(xs, ws[0], ws[2], ws[3], oh, ow, s, p, elem=1)
        want = conv_cuda.conv2d_q8(x, w, s, p, d, dq)
        times = {}
        for name, alt in _variants(plan).items():
            if alt.block_n < 64 or (name != "plan" and alt == plan) or \
                    (alt.block_n == 128 and ws[0] <= 64):
                continue
            conv_cuda.conv_plan = lambda *a, _alt=alt, **k: _alt
            try:
                got = conv_cuda.conv2d_q8(x, w, s, p, d, dq)
                if not torch.equal(got, want):
                    raise RuntimeError(f"K11 {name} is not bitwise the plan's")
                times[name] = cs._device_ms(
                    lambda: conv_cuda.conv2d_q8(x, w, s, p, d, dq))
            finally:
                conv_cuda.conv_plan = planner
        xb = torch.randn(xs, generator=gen).to(torch.bfloat16).cuda()
        wb = (torch.randn(ws, generator=gen) * 0.1).to(torch.bfloat16).cuda() \
            .contiguous(memory_format=torch.channels_last)
        times["K1_bf16"] = cs._device_ms(lambda: conv_cuda.conv2d(xb, wb, s, p,
                                                                  d))
        if parent is not None:
            w_ohwi = w.permute(0, 2, 3, 1)
            if not torch.equal(parent(x, w_ohwi, s, p, d, dq), want):
                raise RuntimeError("the parent's K11 disagrees with this "
                                   "tree's")
            times["parent"] = cs._device_ms(
                lambda: parent(x, w_ohwi, s, p, d, dq))
        nbytes = conv_cuda.conv_bytes(x, w, s, p, d) + 4 * ws[0]
        bound = max(conv_cuda.conv_flops(x, w, s, p, d) / cs.PEAK_INT8_OPS,
                    nbytes / cs.PEAK_BYTES) * 1e3
        for k, v in times.items():
            totals[k] = totals.get(k, 0.0) + v * n
        totals["bound"] = totals.get("bound", 0.0) + bound * n
        say(f"K11 b{batch} x{list(xs)} w{list(ws)} s{list(s)} x{n} plan("
            f"{'flat' if plan.flat else f'box {plan.lbn}{plan.lbh}{plan.lbw}'}"
            f" n{plan.block_n} tiles {plan.tiles} steps {plan.steps} split "
            f"{plan.splits} stages {plan.stages}) bound {bound:.4f}: "
            + " ".join(f"{k} {v:.4f}" for k, v in times.items()))
    say(f"K11 b{batch} per request (ms): "
        + " ".join(f"{k} {v:.4f}" for k, v in totals.items()))


def sweep_k3(pt, conv_cuda, resnet, say):
    import torch
    gen = torch.Generator().manual_seed(cs.SEED + 3)
    main = cs._resnet50_train(pt, resnet)[0]
    convs = cs.zoo_kernel_shapes(main, cs.TRAIN_BATCH)[0]["K4"]
    planner = conv_cuda.wgrad_plan
    best_total = plan_total = lib_total = 0.0
    for (xs, ws, s, p, d), n in convs.items():
        x = torch.randn(xs, generator=gen).to(torch.bfloat16).cuda()
        w = torch.empty(ws, device="meta")
        oh, ow = conv_cuda._out_hw(x, w, s, p, d)
        dout = torch.randn((xs[0], oh, ow, ws[0]), generator=gen) \
            .to(torch.bfloat16).cuda()
        plan = planner(xs, tuple(dout.shape), ws[2], ws[3], s, p)
        times = {}                      # (stages, splits) -> ms
        for st in (plan.stages, 3):     # 3: two 32-KB-stage blocks an SM
            for k in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192,
                      256):
                if k > plan.steps:
                    break
                per = -(-plan.steps // k)
                alt = dataclasses.replace(plan, splits=-(-plan.steps // per),
                                          per=per, stages=min(st, per))
                if (st, alt.splits) in times:
                    continue
                conv_cuda.wgrad_plan = lambda *a, _alt=alt, **kw: _alt
                try:
                    times[(st, alt.splits)] = cs._device_ms(
                        lambda: conv_cuda.conv2d_grad_filter(
                            x, dout, ws[2:], s, p, d, out_dtype=torch.float32))
                finally:
                    conv_cuda.wgrad_plan = planner
        mine = cs._device_ms(lambda: conv_cuda.conv2d_grad_filter(
            x, dout, ws[2:], s, p, d, out_dtype=torch.float32))
        lib = cs._device_ms(lambda: torch.nn.grad.conv2d_weight(
            x.permute(0, 3, 1, 2), ws, dout.permute(0, 3, 1, 2), s, p, d))
        nbytes = conv_cuda.input_bytes(x, w, s, p, d) + dout.numel() * 2 \
            + w.numel() * 4
        bound = max(conv_cuda.conv_flops(x, w, s, p, d) / cs.PEAK_BF16_FLOPS,
                    nbytes / cs.PEAK_BYTES) * 1e3
        best = min(times, key=times.get)
        best_total += times[best] * n
        plan_total += mine * n
        lib_total += lib * n
        say(f"K3 x{list(xs)} w{list(ws)} s{list(s)} x{n} plan tile "
            f"{64 * plan.nwg}x{plan.block_n} tiles {plan.tiles} slices "
            f"{plan.steps} split {plan.splits} stages {plan.stages}: "
            f"{mine:.4f}; best: stages {best[0]} split {best[1]} "
            f"{times[best]:.4f}; "
            f"conv2d_weight {lib:.4f}, bound {bound:.4f} | "
            + " ".join(f"{b}/{k}:{v:.4f}" for (b, k), v in times.items()))
    say(f"K3 per step (ms): plan {plan_total:.4f}, best splits "
        f"{best_total:.4f}, conv2d_weight {lib_total:.4f}")


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="*", choices=("k1", "q8", "k3"))
    ap.add_argument("--parent", type=Path,
                    help="an older checkout whose K11 is timed beside (q8)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_conv_sweep: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import conv_cuda
    torch.backends.cudnn.allow_tf32 = False
    what = set(args.what) or {"k1", "q8", "k3"}

    def say(line):
        print(line, flush=True)
    say(f"{cs._card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if "k1" in what:
        for batch in (16, 4, 1):
            sweep_k1(pt, conv_cuda, resnet, batch, say)
    if "q8" in what:
        parent = None if args.parent is None else cs.parent_q8(args.parent)
        for batch in (16, 4, 1):
            sweep_q8(pt, conv_cuda, resnet, batch, say, parent)
    if "k3" in what:
        sweep_k3(pt, conv_cuda, resnet, say)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
