"""One rank of a gloo group for tests/test_torch_parallel_ranks.py and
tests/test_torch_smoke_parallel.py: python torch_parallel_worker.py RANK
WORLD STORE CASES OUT.

Each case (a dict, see tests/torch_parallel_nets.py) builds its program
with the port, tags it with the case's mesh and annotations, loads the
given whole initial state on every rank and trains on the global batches
it is fed (its own startup's when given none); a `ckpt` case saves a checkpoint after `ckpt` steps, loads it
into a fresh scope and runs the rest from there. The rank writes, per
case, the losses it fetched, the whole state after the steps
(parallel.spmd.gather_state for its shards), a digest of each state tensor
it holds (replicated ones must agree bit for bit across ranks), the bytes
it holds per parameter, and the sharded run's counters. Cases of a
`kind` in KINDS run something else: the collectives on the card
(tests/test_torch_parallel_gpu.py), gpipe over a 'pp' axis
(tests/test_torch_pipeline.py), or a program on the group's mesh beside
its one-rank run (tests/test_torch_split_batch.py). The group's backend is
PARALLEL_TEST_BACKEND (gloo by default); an NCCL rank takes card rank
modulo the cards. It imports torch and the port,
never jax."""

import datetime
import hashlib
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_nets as nets  # noqa: E402


def _np(v):
    return np.asarray(v.detach().cpu().float() if v.dtype == torch.bfloat16
                      else v.detach().cpu())


def run_case(pt, case):
    from paddle_tpu_torch.parallel import _collectives, spmd
    saved_env = {k: os.environ.get(k) for k in case.get("env", {})}
    os.environ.update(case.get("env", {}))
    try:
        main, startup, loss = nets.BUILDERS[case["net"]](pt, case)
        card = case.get("device") == "cuda"
        # a gloo group keeps its tensors on the card it shares; an NCCL
        # rank is on its own card (main)
        nccl = dist.get_backend() == "nccl"
        main._mesh = pt.parallel.make_mesh(
            *case["mesh"], device="cuda" if card and not nccl else None)
        nets.shard(pt, main, case)
        spmd.COUNTERS.reset()
        _collectives.COUNTERS.reset()
        scope = pt.Scope()
        exe = pt.Executor(pt.CUDAPlace(torch.cuda.current_device())
                          if card else pt.CPUPlace())
        from paddle_tpu_torch import executor as E
        E.COUNTERS.reset()
        if case["init"]:
            pt.interop.load_numpy_params(scope, case["init"], exe.device)
        else:
            exe.run(startup, scope=scope)
        fetch = [loss] + [getattr(main, "_acc")] \
            if hasattr(main, "_acc") else [loss]
        losses, accs = [], []
        for i, f in enumerate(case["feeds"]):
            if case.get("ckpt") == i:
                with pt.scope_guard(scope):
                    pt.parallel.multihost.save_checkpoint(
                        exe, case["ckpt_dir"], i, main_program=main)
                scope = pt.Scope()
                with pt.scope_guard(scope):
                    meta = pt.parallel.multihost.load_checkpoint(
                        exe, case["ckpt_dir"], main_program=main)
                assert meta["step"] == i, meta
            out = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            losses.append(float(np.ravel(out[0])[0]))
            if len(out) > 1:
                accs.append(float(np.ravel(out[1])[0]))
        whole = spmd.gather_state(main, scope)
        state = {n: _np(whole[n] if n in whole else scope.find_var(n))
                 for n in case["init"] if scope.find_var(n) is not None}
        held = {n: scope.find_var(n) for n in case["init"]
                if scope.find_var(n) is not None}
        digest = {n: hashlib.sha1(_np(v).tobytes()).hexdigest()
                  for n, v in held.items()}
        nbytes = {n: int(v.numel() * v.element_size())
                  for n, v in held.items()}
        psb = pt.parallel.per_shard_param_bytes(main, scope)
        plan = getattr(main, "_sharding_plan", None)
        return {"losses": losses, "accs": accs, "state": state,
                "digest": digest, "nbytes": nbytes,
                "per_shard": {n: d["per_device"]
                              for n, d in psb["params"].items()},
                "plan": None if plan is None else plan.to_dict(),
                "validate": (pt.parallel.validate_plan_bytes(main, scope)
                             if plan is not None else None),
                "buckets": spmd.COUNTERS.buckets,
                "gathers": sum(spmd.COUNTERS.gathers.values()),
                "reduces": dict(spmd.COUNTERS.reduces),
                "staged": dict(_collectives.COUNTERS.host_staged),
                "eager": dict(E.COUNTERS.eager),
                "graphs": {"captures": E.COUNTERS.captures,
                           "replays": E.COUNTERS.replays},
                "calls": dict(_collectives.COUNTERS.calls)}
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_collectives(pt, case):
    """The collectives on this rank's card (a gloo group stages them
    through pinned host memory): each against its plain result."""
    from paddle_tpu_torch.parallel import _collectives as C
    C.COUNTERS.reset()
    mesh = pt.parallel.make_mesh((dist.get_world_size(),), ("dp",),
                                 device="cuda")
    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", 0)
    x = torch.arange(6, dtype=torch.float32, device=dev) + r
    b = (torch.arange(6, device=dev) + 10 * r).to(torch.bfloat16)
    out = {"all_reduce": C.all_reduce(x, mesh, "dp").cpu().numpy(),
           "all_gather": C.all_gather(x, mesh, "dp").cpu().numpy(),
           "gather_bf16": C.all_gather(b, mesh, "dp").float().cpu().numpy(),
           "reduce_scatter": C.reduce_scatter(
               x.reshape(n, -1).repeat(1, 1), mesh, "dp").cpu().numpy(),
           "broadcast": C.broadcast(x, mesh, "dp").cpu().numpy()}
    pend = C.all_reduce_async([x, 2 * x], mesh, "dp", site="bucket")
    a, c = pend.wait()
    out["async"] = (a.cpu().numpy(), c.cpu().numpy(),
                    a.device.type, a.dtype == torch.float32)
    out["staged"] = dict(C.COUNTERS.host_staged)
    return out


def run_nccl_graph(pt, case):
    """Collectives captured in CUDA graphs on a one-rank NCCL group:
    a bucket all-reduce and an all-gather (out of place, so NCCL copies
    even on one rank), each replayed on new values; then the MLP
    transpiled over the group, graphed, beside the same MLP with no group:
    the collectives posted at each step (the warm-up and the capture post
    them; a replay posts none from the host) and the losses of both."""
    from paddle_tpu_torch import executor as E
    from paddle_tpu_torch.parallel import _collectives as C
    mesh = pt.parallel.make_mesh((1,), ("dp",))
    x = torch.ones(1024, device="cuda")
    C.all_reduce(x, mesh, "dp")             # the communicator, eagerly
    torch.cuda.synchronize()
    box = {}

    def body():
        box["y"] = C.all_reduce_async([x * 2], mesh, "dp",
                                      site="bucket").wait()[0]
        box["g"] = C.all_gather(x * 3, mesh, "dp")
    g = E.capture_graph(body)
    x.fill_(3.0)
    g.replay()
    torch.cuda.synchronize()
    out = {"replayed": box["y"].cpu().numpy(),
           "gathered": box["g"].cpu().numpy()}
    plain, _s, loss_a = nets.mlp(pt, {})
    grouped, startup, loss_b = nets.mlp(pt, {})
    pt.DistributeTranspiler().transpile(program=grouped, trainers=1,
                                        mesh=mesh)
    exe = pt.Executor(pt.CUDAPlace(0))
    scopes = [pt.Scope(), pt.Scope()]
    for sc in scopes:
        exe.run(startup, scope=sc)
    init = {n: v.clone() for n, v in scopes[0].vars.items()
            if isinstance(v, torch.Tensor)}
    for n, v in init.items():
        scopes[1].set_var(n, v.clone())
    E.COUNTERS.reset()
    calls, losses = [], []
    for f in nets.feeds("mlp", 5, seed=1):
        la, = exe.run(plain, feed=f, fetch_list=[loss_a], scope=scopes[0])
        C.COUNTERS.reset()
        lb, = exe.run(grouped, feed=f, fetch_list=[loss_b],
                      scope=scopes[1])
        calls.append(sum(C.COUNTERS.calls.values()))
        losses.append((float(np.ravel(la)[0]), float(np.ravel(lb)[0])))
    out.update(calls=calls, losses=losses, captures=E.COUNTERS.captures,
               replays=E.COUNTERS.replays,
               gate=exe.graph_gate(grouped, {k: torch.from_numpy(v) for
                                             k, v in f.items()}))
    return out


def run_gpipe(pt, case):
    """parallel.pipeline.gpipe of tanh(h @ w + b) stages over this group's
    'pp' axis (the whole stacks given, so each rank's gradient lands in its
    stage's rows): the replicated outputs, the gradients of sum(out^2) by
    the stacks and the microbatches, and the collectives posted."""
    from paddle_tpu_torch.parallel import _collectives as C
    from paddle_tpu_torch.parallel import pipeline
    C.COUNTERS.reset()
    mesh = pt.parallel.make_mesh((dist.get_world_size(),), ("pp",))
    ws = torch.from_numpy(case["ws"]).requires_grad_()
    bs = torch.from_numpy(case["bs"]).requires_grad_()
    xs = torch.from_numpy(case["xs"]).requires_grad_()

    def stage(params, h):
        w, b = params
        return torch.tanh(h @ w + b)
    out = pipeline.gpipe(stage, (ws, bs), xs, mesh)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "gw": ws.grad.numpy(),
            "gb": bs.grad.numpy(), "gx": xs.grad.numpy(),
            "calls": dict(C.COUNTERS.calls)}


def run_split(pt, case):
    """The case's program on the group's mesh and, on this same rank, with
    no mesh (one rank), from one startup state, eager, on the card where
    the case's device is cuda: per step the loss and main._fetch's values
    (split ones gathered), K6's launches and the K6 windows' hits and
    fallbacks; then the state after the steps."""
    from paddle_tpu_torch.ops import bn_cuda
    card = case.get("device") == "cuda"
    out, init = {}, None
    for form in ("split", "one"):
        main, startup, loss = nets.BUILDERS[case["net"]](pt, case)
        if form == "split":
            main._mesh = pt.parallel.make_mesh(
                *case["mesh"], device="cuda" if card else None)
        exe = pt.Executor(pt.CUDAPlace(0) if card else pt.CPUPlace())
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            init = {n: v.clone() for n, v in scope.vars.items()
                    if isinstance(v, torch.Tensor)}
        for n, v in init.items():
            scope.set_var(n, v.clone())
        steps = []
        for f in case["feeds"]:
            bn_cuda.COUNTERS.reset()
            vals = exe.run(main, feed=f, fetch_list=[loss] + main._fetch,
                           scope=scope, use_jit=False)
            steps.append({"fetch": [np.asarray(v, np.float32)
                                    for v in vals],
                          "k6": (bn_cuda.COUNTERS.act_launches,
                                 dict(bn_cuda.COUNTERS.split_launches)),
                          "hits": dict(bn_cuda.COUNTERS.hits),
                          "fallbacks": {f"{o}:{r}": k for (o, r), k in
                                        bn_cuda.COUNTERS.fallbacks.items()}})
        windows = sum(1 for op in main.global_block().ops
                      if op.type == "batch_norm"
                      and not op.attr("is_test", False))
        out[form] = {"steps": steps, "windows": windows,
                     "state": {n: _np(scope.find_var(n)) for n in init
                               if isinstance(scope.find_var(n),
                                             torch.Tensor)}}
    return out


KINDS = {"collectives": run_collectives, "nccl_graph": run_nccl_graph,
         "gpipe": run_gpipe, "split": run_split}


def main(argv):
    rank, world, store, cases_path, out_path = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    backend = os.environ.get("PARALLEL_TEST_BACKEND", "gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend,
                            init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    import paddle_tpu_torch as pt
    assert "jax" not in sys.modules
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = {}
    try:
        for case in cases:
            if case.get("kind") in KINDS:
                out[case["name"]] = KINDS[case["kind"]](pt, case)
                continue
            if case.get("expect_error"):
                try:
                    run_case(pt, case)
                    out[case["name"]] = {"error": None}
                except Exception as e:  # noqa: BLE001 - recorded for the test
                    out[case["name"]] = {"error": f"{type(e).__name__}: {e}"}
                continue
            out[case["name"]] = run_case(pt, case)
        # no rank tears its connections down while a peer still talks
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
    # leave without the interpreter's teardown, where a process group's
    # threads may be destroyed unjoined and abort the process
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
