"""One rank of a torch.distributed gloo group on the CPU, for
tests/test_torch_ring_attention.py: runs the port's ring attention and the
programs around it on this rank and writes what it computed.

    python tests/torch_ring_worker.py RANK WORLD STORE CASES OUT

STORE is the path of a file store for init_process_group, CASES a pickled
list of case dicts (numpy inputs, see `RUNNERS`), OUT the pickle this rank
writes: {case name: {output name: numpy array}}, and under "__place__"
the CUDA device index `Executor()` would take on this rank. It imports torch and the
port only, never JAX. The builders here are shared with the test file,
which runs the same cases in one process (world size 1).
"""

from __future__ import annotations

import datetime
import pickle
import sys

import numpy as np
import torch


def _np(t):
    return t.detach().float().cpu().numpy()


def run_ring(pt, mesh, case):
    """ring_attention_sharded on global q, k, v: Out and LSE, then the
    grads of sum(Out * dO) through the flash ring's autograd Function or
    autograd through the einsum ring."""
    from paddle_tpu_torch.parallel import ring_attention as R
    dt = torch.bfloat16 if case.get("dtype") == "bfloat16" else torch.float32
    q, k, v, do = (torch.from_numpy(case[n]).to(dt) for n in ("q", "k", "v",
                                                             "do"))
    kw = dict(causal=case["causal"], use_flash=case["use_flash"])
    out, lse = R.ring_attention_sharded(q, k, v, mesh, return_lse=True, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    R.ring_attention_sharded(*leaves, mesh, **kw).backward(do)
    return {"out": _np(out), "lse": _np(lse),
            **{n: _np(t.grad) for n, t in zip(("dq", "dk", "dv"), leaves)}}


def attention_program(pt, shape, seq_par, mesh, grads):
    """tests/test_ring_attention.py TestAttentionOpInProgram's program: q,
    k, v fed [B, T, H, D] f32, causal fused_attention; with `grads`, the
    loss mean(out * out) and append_backward. Returns (main, fetch names)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        qkv = []
        for n in ("q", "k", "v"):
            var = pt.layers.data(name=n, shape=list(shape), dtype="float32",
                                 append_batch_size=False)
            if grads:
                var.stop_gradient = False
                var.desc.stop_gradient = False
            qkv.append(var)
        out = pt.layers.fused_attention(*qkv, causal=True,
                                        sequence_parallel=seq_par)
        fetch = [out.name]
        if grads:
            loss = pt.layers.mean(pt.layers.elementwise_mul(out, out))
            pt.backward.append_backward(loss)
            sdpa, = [op for op in main.global_block().ops
                     if op.type == "scaled_dot_product_attention"]
            fetch = [n + "@GRAD" for n in ("q", "k", "v")] + \
                [sdpa.output("LSE")[0]]
    if mesh is not None:
        main._mesh = mesh
        for n in ("q", "k", "v"):
            pt.parallel.shard_feed(main, n, (None, "sp", None, None))
    return main, fetch


def run_op(pt, mesh, case):
    main, fetch = attention_program(pt, case["q"].shape, True, mesh,
                                    case["grads"])
    got = pt.Executor(pt.CPUPlace()).run(
        main, feed={n: case[n] for n in ("q", "k", "v")}, fetch_list=fetch,
        scope=pt.Scope())
    return {f"out{i}": np.asarray(g, np.float32) for i, g in enumerate(got)}


LM = {"seqlen": 256, "n_layer": 2, "d_model": 128, "n_head": 2,
      "vocab": 512, "batch": 2, "lr": 1e-3}


def lm_program(fluid, models, amp, sequence_parallel, use_flash=True):
    """transformer_lm at LM's size with Adam (amp.decorate O2 when `amp`),
    through either package's fluid API (the same script)."""
    t = LM["seqlen"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tok = fluid.layers.data(name="tok", shape=[-1, t], dtype="int64",
                                append_batch_size=False)
        lab = fluid.layers.data(name="lab", shape=[-1, t], dtype="int64",
                                append_batch_size=False)
        loss = models.transformer_lm(
            tok, lab, vocab_size=LM["vocab"], d_model=LM["d_model"],
            n_head=LM["n_head"], n_layer=LM["n_layer"], use_flash=use_flash,
            sequence_parallel=sequence_parallel)
        opt = fluid.optimizer.Adam(learning_rate=LM["lr"])
        if amp:
            opt = fluid.amp.decorate(opt, level="O2")
        opt.minimize(loss, startup_program=startup)
    return main, startup, loss


def lm_params(main):
    return sorted(p.name for p in main.global_block().all_parameters())


def run_lm_step(pt, mesh, case):
    """One Adam step of the ring program from the given state: the loss,
    every parameter's grad, and the state after the step."""
    main, _, loss = lm_program(pt, pt.models, case["amp"], True)
    main._mesh = mesh
    scope = pt.Scope()
    pt.interop.load_numpy_params(scope, case["init"], "cpu")
    params = lm_params(main)
    out = pt.Executor(pt.CPUPlace()).run(
        main, feed=case["feed"], scope=scope,
        fetch_list=[loss] + [p + "@GRAD" for p in params])
    res = {"loss": np.asarray(out[0], np.float32)}
    res.update({f"grad/{p}": np.asarray(g, np.float32)
                for p, g in zip(params, out[1:])})
    res.update({f"after/{n}": _np(scope.find_var(n)) for n in case["init"]})
    return res


RUNNERS = {"ring": run_ring, "op": run_op, "lm": run_lm_step}


def main(argv):
    rank, world, store, cases_path, out_path = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import attention_cuda
    mesh = pt.parallel.make_mesh((world,), ("sp",))
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    # what Executor() would run on in this group (LOCAL_RANK unset: the rank)
    results = {"__place__": pt.executor.default_place().device_id}
    for case in cases:
        attention_cuda.COUNTERS.reset()
        results[case["name"]] = RUNNERS[case["kind"]](pt, mesh, case)
        results[case["name"]]["counters"] = (
            dict(attention_cuda.COUNTERS.hits),
            dict(attention_cuda.COUNTERS.fallbacks))
    with open(out_path, "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
