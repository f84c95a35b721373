"""Whether torch.profiler sees every kernel a CUDA graph replays: the
ResNet-50 O3 training step (chip_smoke.py's train_q8 path, batch 32 at
224x224, int8) captured on `--graphs` fresh Executors, each graph's kernel
nodes (chip_smoke._graph_launches, read from the graph itself) beside the
kernel records of `--replays` profiled replays of it (kineto's raw
records, chip_smoke._raw_trace_launches).

Prints one JSON line per graph: its nodes and, per replay, the counters
whose records differ from the nodes, the kernel records in all, and the
window's launch lead (chip_smoke._launch_lead_us). A replay whose records
differ also leaves its chrome trace under `--out`. The last line sums up.

Run on a machine with the card (about 80 s for 40 graphs):

    python tests/torch_trace_probe.py [--graphs 40] [--replays 3] [--out chiprun_out/trace_probe]
"""

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graphs", type=int, default=40)
    ap.add_argument("--replays", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/trace_probe")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import cuda_build
    cuda_build.build()
    (_, (main_prog, startup, loss), _, feed, _, want, _, _), = \
        S._q3_paths(pt, resnet, names=("resnet50_o3",))
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    init = {n: v for n, v in scope.vars.items() if isinstance(v, torch.Tensor)}
    short_graphs = []
    for g in range(args.graphs):
        exe = pt.Executor()
        sc = S._scope_from(pt, init)
        with S._kept_graphs():
            for _ in range(S.GRAPH_BITWISE_STEPS):
                exe.run(main_prog, feed=feed, fetch_list=[loss], scope=sc)
        graph, = (e.graph for e in exe._graphs.values())
        nodes = S._graph_launches(graph)
        row = {"graph": g, "nodes": {k: v for k, v in nodes.items() if v},
               "replays": []}
        for r in range(args.replays):
            with S._profiled() as prof:
                exe.run(main_prog, feed=feed, fetch_list=[loss], scope=sc)
            raw = S._raw_trace_launches(prof)
            rep = {"differ": {k: (raw[k], v) for k, v in nodes.items()
                              if raw[k] != v},
                   "kernel_records": sum(
                       1 for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA),
                   "lead_us": S.LAUNCH_LEADS_US[-1]}
            if rep["differ"]:
                prof.export_chrome_trace(str(out / f"graph{g}_replay{r}.json"))
            row["replays"].append(rep)
        if any(rep["differ"] for rep in row["replays"]):
            short_graphs.append(g)
        print(json.dumps(row), flush=True)
        del exe, sc, graph
        torch.cuda.empty_cache()
    print(json.dumps({"graphs": args.graphs, "replays": args.replays,
                      "expected": want, "graphs_whose_records_differ":
                      short_graphs, "card": S._card_line()}))


if __name__ == "__main__":
    main()
