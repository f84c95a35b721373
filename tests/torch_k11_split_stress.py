"""K11's split-K held against its plain version many times over, to look for
a fault that one pass of chip_smoke's check (`_q8_splits_hold`) may miss:
at every quantized ResNet-50 conv shape of the batch-1, -4 and -16 buckets,
the plan as `conv_plan` gives it, split-K forced to 2, 3 and 4 as the smoke
forces it (a ring of max(per, 2) stages) and with a ring of at most `per`
stages; bf16 and f32 out, every second call writing over memory that held
garbage. Each output must equal `conv2d_q8_reference` bit for bit.

    python tests/torch_k11_split_stress.py [--reps 100] [--reps-hot 3000]
        [--load SECONDS] [--smoke-rounds N] [--out FILE]

--reps-hot applies to x [1, 56, 56, 256] w [512, 256, 1, 1] stride 2, the
shape of the one disagreement seen so far. --load keeps the card busy from
a second process (bf16 GEMMs and a 1 GiB sweep) while the calls run.
--smoke-rounds N first runs chip_smoke's phase_kernel and phase_slice, then
its phase_kernel_q8 N times, each disagreement printed with its rows and
whether the same calls repeat it. Prints one JSON line last; exits 1 if any
call disagreed, 2 without a CUDA device.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

HOT = ((1, 56, 56, 256), (512, 256, 1, 1), (2, 2))


def _hammer(seconds):
    import torch
    end = time.time() + seconds
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    big = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    while time.time() < end:
        for _ in range(4):
            a @ b
        big.add_(1)
        torch.cuda.synchronize()
    return 0


def _plans(conv_cuda, x, w, key):
    """name -> plan: the planned one and the forced splits."""
    s, p, d = key[2:]
    oh, ow = conv_cuda._out_hw(x, w, s, p, d)
    co, _, kh, kw = w.shape
    plan = conv_cuda.conv_plan(tuple(x.shape), co, kh, kw, oh, ow, s, p,
                               elem=1)
    out = {"plan": plan}
    for k in (2, 3, 4):
        if k > plan.steps:
            continue
        per = -(-plan.steps // k)
        splits = -(-plan.steps // per)
        out[f"split{k}"] = dataclasses.replace(
            plan, splits=splits, per=per,
            stages=min(plan.stages, max(per, 2)))
        out[f"split{k}_ring{min(per, plan.stages)}"] = dataclasses.replace(
            plan, splits=splits, per=per,
            stages=max(1, min(plan.stages, per)))
    return out


def _stress(conv_cuda, keys, operands, reps, reps_hot, bad):
    import torch
    planner = conv_cuda.conv_plan
    calls = 0

    def call(x, w, key, dq, plan, out_dtype, garbage):
        oh, ow = conv_cuda._out_hw(x, w, *key[2:])
        m = x.shape[0] * oh * ow
        if garbage:   # freed blocks of the sizes the wrapper asks for next
            size = 4 if out_dtype == torch.float32 else 2
            junk = [torch.full((m * w.shape[0] * size // 4,), 0x3f3f3f3f,
                               dtype=torch.int32, device="cuda")]
            if plan.splits > 1:
                junk.append(torch.full((plan.splits, m, w.shape[0]),
                                       0x3f3f3f3f, dtype=torch.int32,
                                       device="cuda"))
            del junk
        conv_cuda.conv_plan = lambda *a, **kw: plan
        try:
            return conv_cuda.conv2d_q8(x, w, *key[2:], dq,
                                       out_dtype=out_dtype)
        finally:
            conv_cuda.conv_plan = planner

    for key in keys:
        x, w, dq = operands(*key[:2])
        want = {torch.bfloat16: conv_cuda.conv2d_q8_reference(
                    x, w, *key[2:], dq),
                torch.float32: conv_cuda.conv2d_q8_reference(
                    x, w, *key[2:], dq, out_dtype=torch.float32)}
        n = reps_hot if tuple(key[:3]) == HOT else reps
        for tag, plan in _plans(conv_cuda, x, w, key).items():
            for r in range(n):
                for out_dtype, ref in want.items():
                    y = call(x, w, key, dq, plan, out_dtype, r % 2 == 0)
                    torch.cuda.synchronize()
                    calls += 1
                    if torch.equal(y, ref):
                        continue
                    off = (y != ref).reshape(-1, y.shape[-1])
                    ent = {"key": repr(key), "plan": tag,
                           "splits": plan.splits, "stages": plan.stages,
                           "rep": r, "out": str(out_dtype),
                           "elements": int(off.sum()),
                           "rows": off.any(1).nonzero().flatten()[:16]
                           .tolist()}
                    bad.append(ent)
                    print("disagrees:", json.dumps(ent), flush=True)
    return calls


def _smoke_rounds(pt, conv_cuda, resnet, rounds, bad):
    import torch
    hold = chip_smoke._q8_splits_hold

    def held(*a):
        try:
            return hold(*a)
        except RuntimeError as e:       # the smoke's message says where
            bad.append({"smoke": str(e)})
            print("disagrees:", e, flush=True)
            return [1]
    chip_smoke._q8_splits_hold = held
    try:
        report = {}
        chip_smoke.phase_kernel(pt, conv_cuda, resnet, report)
        chip_smoke.phase_slice(pt, conv_cuda, resnet, report)
        for _ in range(rounds):
            chip_smoke.phase_kernel_q8(pt, conv_cuda, resnet, report)
            torch.cuda.synchronize()
    finally:
        chip_smoke._q8_splits_hold = hold


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--reps-hot", type=int, default=3000)
    ap.add_argument("--load", type=float, default=0.0)
    ap.add_argument("--smoke-rounds", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--hammer", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_k11_split_stress: no CUDA device", file=sys.stderr)
        return 2
    if args.hammer:
        return _hammer(args.hammer)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import conv_cuda, cuda_build
    cuda_build.build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke._card_line()
    print(f"device: {card}", flush=True)
    bad = []
    out = {"card": card}
    if args.smoke_rounds:
        t0 = time.perf_counter()
        _smoke_rounds(pt, conv_cuda, resnet, args.smoke_rounds, bad)
        out["smoke_rounds"] = args.smoke_rounds
        out["smoke_seconds"] = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 7)

    def operands(xs, ws):
        x = torch.randint(-127, 128, xs, generator=gen, dtype=torch.int8)
        w = torch.randint(-127, 128, ws, generator=gen, dtype=torch.int8)
        dq = torch.rand(ws[0], generator=gen) * 1e-4 + 1e-6
        return x.cuda(), w.cuda(), dq.cuda()

    main_prog = chip_smoke._resnet50(pt, resnet)[0]
    keys = []
    for b in chip_smoke.BUCKETS:
        for key in chip_smoke._eligible_convs(conv_cuda, main_prog, b, quant):
            if key not in keys:
                keys.append(key)
    hammer = None
    if args.load:
        hammer = subprocess.Popen([sys.executable, __file__, "--hammer",
                                   str(args.load)])
        time.sleep(8)                    # its context and first GEMMs
    try:
        t0 = time.perf_counter()
        out["calls"] = _stress(conv_cuda, keys, operands, args.reps,
                               args.reps_hot, bad)
        out["seconds"] = time.perf_counter() - t0
    finally:
        if hammer is not None:
            hammer.kill()
            hammer.wait()
    out.update(shapes=len(keys), load_seconds=args.load,
               disagreements=len(bad))
    if args.out:
        Path(args.out).write_text(json.dumps({**out, "bad": bad}, indent=1))
    print(json.dumps(out), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
