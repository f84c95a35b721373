"""What a served LM's logits cost on the host: the ways a bucket's fetch
can reach the caller as a fresh float32 numpy array, timed on the card at
the transformer LM's serving shape ([bucket, 2048, 8192] bf16, buckets 1,
2, 4, 8, as chip_smoke.py's serve_lm phase serves it):

  * pageable: the rows in bf16 to pageable memory, widened there;
  * widen_on_card: widened to f32 on the card, then to pageable memory;
  * pinned: the rows in bf16 into a fresh pinned block, widened there;
  * widen_on_card_pinned: widened on the card, then into a fresh pinned
    block;
  * engine: serving.engine._fetch_rows, the engine's own trip (the last
    way, in one call).

Each way reports the copy to the host (which waits for the card) and the
numpy step after it, medians of `--reps`, in ms. The logits are random
from a seed; the copies do not depend on their values.

Run on a machine with the card (about 20 s):

    python tests/torch_logits_host_probe.py [--reps 5] [--json out.json]

Prints one JSON object.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from paddle_tpu_torch.serving.engine import _fetch_rows  # noqa: E402

BUCKETS = (1, 2, 4, 8)
SEQLEN, VOCAB = 2048, 8192
WAYS = ("pageable", "widen_on_card", "pinned", "widen_on_card_pinned")


def to_host(f, how):
    """`f` as a fresh float32 numpy array by way `how` (WAYS): (ms of the
    copy to the host, ms of the numpy step after it, the array)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if how in ("pageable", "widen_on_card"):
        h = (f.float() if how == "widen_on_card" else f).cpu()
    else:
        src = f.float() if how == "widen_on_card_pinned" else f
        h = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        h.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if h.dtype != torch.float32:
        if how == "pinned":
            h = torch.empty(h.shape, dtype=torch.float32,
                            pin_memory=True).copy_(h)
        else:
            h = h.float()
    a = h.numpy()
    return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3, a


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    logits = torch.randn((BUCKETS[-1], SEQLEN, VOCAB), generator=g,
                         device="cuda").to(torch.bfloat16)
    out = {"card": card, "shape": [SEQLEN, VOCAB], "dtype": "bfloat16",
           "reps": args.reps, "buckets": {}}
    for b in BUCKETS:
        f = logits[:b]
        want = f.float().cpu().numpy()
        row = {"bytes": f.numel() * f.element_size()}
        ms = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a, = _fetch_rows([f], b)
            ms.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(a, want):
                raise RuntimeError(f"engine: bucket {b} rows differ")
            del a
        row["engine_ms"] = float(np.median(ms))
        for how in WAYS:
            copy, view = [], []
            for _ in range(args.reps):
                c, v, a = to_host(f, how)
                if a.dtype != np.float32 or not np.array_equal(a, want):
                    raise RuntimeError(f"{how}: bucket {b} rows differ")
                copy.append(c)
                view.append(v)
                del a
            row[how] = {"copy_ms": float(np.median(copy)),
                        "numpy_ms": float(np.median(view))}
        out["buckets"][b] = row
    text = json.dumps(out)
    if args.json:
        Path(args.json).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
