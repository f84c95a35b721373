"""The port's ring attention on the CPU against the JAX package's.

  * K10's plain version (ops/attention_cuda.flash_forward_block_reference)
    against pallas_attention.flash_attention_block in interpret mode, and
    K8's and K9's plain versions against flash_attention_bwd_block, at the
    offsets of every (query shard, key shard) pair of a four-shard ring,
    causal and full, f32 and bf16; the pairs wholly in a row's causal
    future come out exactly (0, 0, -1e30) and zero gradients in both.
  * parallel.ring_attention_sharded on gloo groups of 2 and 4 CPU
    processes (tests/torch_ring_worker.py, fresh interpreters, joined with
    a hard timeout) and in one process (world size 1), against the JAX
    ring on a host mesh of the same size (tests/conftest.py gives 8
    devices): Out, LSE and grads, flash and einsum rings, the
    strongly-negative-logit regressions, the program-level op
    (tests/test_ring_attention.py TestAttentionOpInProgram), and one Adam
    step of transformer_lm(sequence_parallel=True).
  * The reference's bf16 ring-carry fault (ROADMAP Queue 3), shown.

Inputs come from a numpy seed and go through both packages.

Tolerances.
  * Plain versions against Pallas, relative to the largest magnitude of
    the JAX output: f32 2e-6, bf16 2^-7 (tests/test_torch_attention.py:
    the same arithmetic, sums in another order; bf16 outputs rounded once
    at the end). m within 1e-6 of max(1, |m|) (the same f32 scores).
  * The ring against the JAX ring, f32: JAX's own tolerances for its ring
    against one device (tests/test_ring_attention.py:30-62): Out and LSE
    rtol 2e-5, atol 2e-6; grads rtol 5e-5, atol 5e-6; the strongly-
    negative-logit cases rtol 1e-4, atol 1e-5 (grads rtol 1e-3); the op
    in a program rtol 2e-5, atol 2e-6, its grads rtol 1e-3, atol 1e-5 and
    LSE rtol 1e-4, atol 1e-4.
  * One Adam step, f32, the port's ring against the JAX ring: loss within
    1e-5 relative, each grad within a relative L2 of 1e-5, the K
    projections' biases (zero in exact arithmetic) under 1e-6 of the
    largest grad norm, the state after the step as
    tests/test_torch_transformer.py holds it.
  * One Adam step, AMP O2, the port's ring on one rank against the JAX
    flash program without 'sp' (the same computation with f32 statistics):
    the tolerances test_torch_transformer.py holds the port's flash
    program to: loss within 1e-3 relative; each grad no further from JAX's O2
    grad than twice JAX's own O2-vs-f32 distance for it, its norm within
    1 %; the K biases under 1e-5 of the largest norm.
  * bf16 LSE: within 1e-5 of max(1, |lse|) (PERF.md's LSE bound) of the
    f32 logsumexp of the same bf16 inputs.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import executor as jax_executor
from paddle_tpu import models as jax_models
from paddle_tpu.ops import pallas_attention
from paddle_tpu.parallel import mesh as jax_mesh
from paddle_tpu.parallel import ring_attention as jring
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import attention_cuda as A
from paddle_tpu_torch.parallel import make_mesh
from paddle_tpu_torch.parallel import ring_attention as R

import torch_ring_worker as W

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_ring_worker.py"
TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -7}
SHARD = (1, 64, 2, 32)          # [B, T/P, H, D] of the four-shard ring pairs
WORKER_TIMEOUT = 300            # seconds for a whole gloo group


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """Take back the op types the JAX executor recorded in this test (see
    tests/test_torch_training.py: the op-coverage gate, ROADMAP Queue 3)."""
    before = set(jax_executor._RECORDED_OPS)
    yield
    jax_executor._RECORDED_OPS.intersection_update(before)


def _arrays(shape, n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(n)]


def _jnp(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-30), f"{what}: {err}"


# --- K10, K8 and K9's plain versions against Pallas at ring offsets --------

_JIT = {}


def _pallas(kind, scale, causal):
    """pallas_attention's block functions, jitted once with the offsets
    traced, as the ring traces them."""
    key = (kind, scale, causal)
    if key not in _JIT:
        block = (pallas_attention.flash_attention_block if kind == "fwd"
                 else pallas_attention.flash_attention_bwd_block)

        def fn(*args):
            *tensors, qo, ko = args
            return block(*tensors, qo, ko, scale, causal)
        _JIT[key] = jax.jit(fn)
    return _JIT[key]


def _ring_operands(dtype, seed):
    b, t, h, d = SHARD
    q, k, v, do = _arrays((b, 4 * t, h, d), 4, seed)
    return ([_jnp(a, dtype) for a in (q, k, v, do)],
            [_torch(a, dtype) for a in (q, k, v, do)])


def _shard(x, i):
    t = SHARD[1]
    return x[:, i * t:(i + 1) * t]


@pytest.mark.parametrize("q_shard", range(4))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_plain_version_matches_pallas(dtype, causal, q_shard):
    """K10's plain version against the Pallas block in interpret mode at
    the four pairs (q_shard, j) of a four-shard ring: offsets past, on and
    before the diagonal."""
    (jq, jk, jv, _), (tq, tk, tv, _) = _ring_operands(dtype, 1)
    t, scale = SHARD[1], 1.0 / np.sqrt(SHARD[-1])
    i = q_shard
    fn = _pallas("fwd", scale, causal)
    with jax.default_matmul_precision("highest"):
        for j in range(4):
            at = f"pair ({i}, {j})"
            acc, l, m = fn(_shard(jq, i), _shard(jk, j), _shard(jv, j),
                           i * t, j * t)
            pacc, pl, pm = A.flash_forward_block_reference(
                _shard(tq, i), _shard(tk, j), _shard(tv, j), i * t, j * t,
                scale, causal)
            assert pacc.dtype == pl.dtype == pm.dtype == torch.float32
            if causal and j > i:           # wholly in the causal future
                for got, want in ((pacc, acc), (pl, l), (pm, m)):
                    assert np.array_equal(_f32(got), _f32(want)), at
                assert (pm == -1e30).all() and (pacc == 0).all(), at
                continue
            _close(pacc, acc, TOL[dtype], f"acc {at}")
            _close(pl, l, TOL["float32"], f"l {at}")
            err = np.abs(_f32(pm) - _f32(m))
            assert (err <= 1e-6 * np.maximum(1, np.abs(_f32(m)))).all(), at


@pytest.mark.parametrize("q_shard", range(4))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_versions_match_pallas_at_offsets(dtype, causal, q_shard):
    """K8's and K9's plain versions against flash_attention_bwd_block at
    the same pairs, from the LSE and delta of the whole sequence's
    forward."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _ring_operands(dtype, 2)
    t, scale = SHARD[1], 1.0 / np.sqrt(SHARD[-1])
    i = q_shard
    fn = _pallas("bwd", scale, causal)
    with jax.default_matmul_precision("highest"):
        o, lse = pallas_attention._forward(jq, jk, jv, causal,
                                           return_lse=True)
        delta = jnp.sum(jdo.astype(jnp.float32) * o.astype(jnp.float32),
                        axis=-1).transpose(0, 2, 1)
        lse_i, delta_i = lse[..., i * t:(i + 1) * t], \
            delta[..., i * t:(i + 1) * t]
        for j in range(4):
            at = f"pair ({i}, {j})"
            want = fn(_shard(jq, i), _shard(jk, j), _shard(jv, j),
                      _shard(jdo, i), lse_i, delta_i, i * t, j * t)
            got = A.flash_attention_bwd_block_reference(
                _shard(tq, i), _shard(tk, j), _shard(tv, j), _shard(tdo, i),
                torch.from_numpy(np.array(lse_i)),
                torch.from_numpy(np.array(delta_i)), i * t, j * t, scale,
                causal)
            for g, w, what in zip(got, want, ("dq", "dk", "dv")):
                assert g.dtype == tq.dtype, what
                if causal and j > i:
                    assert (g == 0).all() and not np.any(_f32(w)), \
                        f"{what} {at}"
                else:
                    _close(g, w, TOL[dtype], f"{what} {at}")


def test_block_supports_is_the_reference_rule():
    for tq, tk in ((8, 8), (16, 8), (64, 64), (128, 256), (256, 128),
                   (96, 96), (12, 12), (4, 4), (128, 192), (24, 16)):
        a = jnp.zeros((1, tq, 1, 8))
        b = jnp.zeros((1, tk, 1, 8))
        assert A.block_supports(torch.zeros(1, tq, 1, 8),
                                torch.zeros(1, tk, 1, 8)) == \
            pallas_attention.block_supports(a, b), (tq, tk)


# --- the ring across ranks ----------------------------------------------------

RING_SHAPE = (2, 64, 2, 16)
NEG_SHAPE = (1, 64, 2, 8)
FAULT_SHAPE = (1, 256, 2, 64)
OP_SHAPE = (2, 32, 2, 8)
OP_GRAD_SHAPE = (2, 128, 2, 8)


def _ring_cases():
    cases = []
    for flash in (True, False):
        for causal in (False, True):
            q, k, v, do = _arrays(RING_SHAPE, 4, 13)
            cases.append({"kind": "ring", "name": f"ring/{flash}/{causal}",
                          "q": q, "k": k, "v": v, "do": do,
                          "causal": causal, "use_flash": flash})
        q, v, do = _arrays(NEG_SHAPE, 3, 99)
        cases.append({"kind": "ring", "name": f"neg/{flash}", "q": q * 10,
                      "k": -q * 10, "v": v, "do": do, "causal": True,
                      "use_flash": flash})
    q, k, v, do = _arrays(FAULT_SHAPE, 4, 7, scale=2.0)
    cases.append({"kind": "ring", "name": "bf16", "q": q, "k": k, "v": v,
                  "do": do, "causal": True, "use_flash": True,
                  "dtype": "bfloat16"})
    q, k, v = _arrays(OP_SHAPE, 3, 77)
    cases.append({"kind": "op", "name": "op", "q": q, "k": k, "v": v,
                  "grads": False})
    q, k, v = _arrays(OP_GRAD_SHAPE, 3, 31)
    cases.append({"kind": "op", "name": "op_grads", "q": q, "k": k, "v": v,
                  "grads": True})
    return cases


def _lm_feed():
    rng = np.random.default_rng(0)
    shape = (W.LM["batch"], W.LM["seqlen"])
    return {"tok": rng.integers(0, W.LM["vocab"], shape).astype(np.int64),
            "lab": rng.integers(0, W.LM["vocab"], shape).astype(np.int64)}


_JAX_LM = {}


def _jax_lm(amp, n_sp):
    """The JAX package's startup state and one Adam step of the LM: on an
    'sp' mesh of n_sp host devices (the ring), or without a mesh (n_sp None:
    the flash program). Returns (init, loss, grads by name, state after)."""
    key = (amp, n_sp)
    if key not in _JAX_LM:
        main, startup, loss = W.lm_program(jfluid, jax_models, amp,
                                           n_sp is not None)
        if n_sp is not None:
            main._mesh = jax_mesh.make_mesh((n_sp,), ("sp",))
        scope = jax_executor.Scope()
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup, scope=scope)
        init = {n: np.array(scope.find_var(n)).astype(np.float32)
                for n, v in startup.global_block().desc.vars.items()
                if v.persistable}
        params = W.lm_params(main)
        out = exe.run(main, feed=_lm_feed(), scope=scope,
                      fetch_list=[loss] + [p + "@GRAD" for p in params])
        after = {n: np.array(scope.find_var(n)).astype(np.float32)
                 for n in init}
        _JAX_LM[key] = (init, float(np.ravel(out[0])[0]),
                        {p: np.asarray(g, np.float32)
                         for p, g in zip(params, out[1:])}, after)
    return _JAX_LM[key]


def _launch(world, cases, tmp):
    """Run `cases` on a fresh gloo group of `world` CPU processes; return
    each rank's results. A rank that fails or a group that outlives
    WORKER_TIMEOUT fails the caller, and every process is gone after."""
    cases_path, store = tmp / "cases.pkl", tmp / "store"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}"
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), str(store),
         str(cases_path), str(tmp / f"out{r}.pkl")], env=env, cwd=tmp,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world}:\n{logs[r][-4000:]}"
    out = []
    for r in range(world):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


_RANKS = {}


def _group(n, tmp_path_factory):
    """Every rank's results of the ring cases (and, at P = 1 and 4, of the
    LM step in f32) on a group of n ranks, run once per n. n = 1 runs in
    this process, with no process group."""
    if n not in _RANKS:
        cases = _ring_cases()
        if n != 2:
            init = _jax_lm(False, n)[0]
            cases.append({"kind": "lm", "name": "lm", "amp": False,
                          "init": init, "feed": _lm_feed()})
        if n == 1:
            mesh = make_mesh((1,), ("sp",))
            res = {}
            for c in cases:
                A.COUNTERS.reset()
                res[c["name"]] = W.RUNNERS[c["kind"]](pt, mesh, c)
                res[c["name"]]["counters"] = (dict(A.COUNTERS.hits),
                                              dict(A.COUNTERS.fallbacks))
            _RANKS[n] = [res]
        else:
            _RANKS[n] = _launch(n, cases, tmp_path_factory.mktemp(f"P{n}"))
    return _RANKS[n]


@pytest.fixture(params=[1, 2, 4], ids=lambda n: f"P{n}")
def ranks(request, tmp_path_factory):
    """(P, every rank's results) for groups of 1, 2 and 4 ranks."""
    return request.param, _group(request.param, tmp_path_factory)


def _case(name):
    return next(c for c in _ring_cases() if c["name"] == name)


def _jax_ring(case, n_sp):
    """The JAX ring on an n_sp-device host mesh: (out, lse, (dq, dk, dv) of
    sum(out * do)). The einsum ring gives all three from one vjp; the
    flash ring's LSE comes from its return_lse call, whose backward the
    caller owns."""
    mesh = jax_mesh.make_mesh((n_sp,), ("sp",))
    dtype = case.get("dtype", "float32")
    q, k, v, do = (_jnp(case[n], dtype) for n in ("q", "k", "v", "do"))
    kw = dict(causal=case["causal"], use_flash=case["use_flash"])
    flash = case["use_flash"]
    with jax.default_matmul_precision("highest"):
        f = lambda a, b, c: jring.ring_attention_sharded(  # noqa: E731
            a, b, c, mesh, return_lse=not flash, **kw)
        if flash:
            _, lse = jring.ring_attention_sharded(q, k, v, mesh,
                                                  return_lse=True, **kw)
            out, vjp = jax.vjp(f, q, k, v)
        else:
            out, vjp, lse = jax.vjp(f, q, k, v, has_aux=True)
        return out, lse, vjp(do)


def _allclose(got, want, rtol, atol, what):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("flash", [True, False], ids=["flash", "einsum"])
def test_ring_matches_jax_ring(ranks, flash, causal):
    """Out, LSE and the grads of sum(Out * dO) against the JAX ring on a
    host mesh of as many devices as the group has ranks (f32)."""
    n, res = ranks
    case = _case(f"ring/{flash}/{causal}")
    out, lse, grads = _jax_ring(case, n)
    got = res[0][case["name"]]
    _allclose(got["out"], out, 2e-5, 2e-6, "out")
    _allclose(got["lse"], lse, 2e-5, 2e-6, "lse")
    for name, w in zip(("dq", "dk", "dv"), grads):
        _allclose(got[name], w, 5e-5, 5e-6, name)
    hits, fallbacks = got["counters"]
    # f32 operands: the flash ring's blocks take the plain versions
    assert fallbacks == ({("ring_attention", "dtype"): 2} if flash else {})
    assert not hits


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "einsum"])
def test_ring_strongly_negative_logits(ranks, flash):
    """tests/test_ring_attention.py:157-200: a later block wholly masked
    must not reset the running max when every true logit is very
    negative; the output is not zero and the grads are finite and match."""
    n, res = ranks
    case = _case(f"neg/{flash}")
    out, _, grads = _jax_ring(case, n)
    got = res[0][case["name"]]
    q, k, v = (torch.from_numpy(case[x]) for x in ("q", "k", "v"))
    want = A.attention_reference(q, k, v, causal=True)
    _allclose(got["out"], want, 1e-4, 1e-5, "out vs one device")
    _allclose(got["out"], out, 1e-4, 1e-5, "out vs the JAX ring")
    assert not np.allclose(got["out"], 0.0)
    for name, w in zip(("dq", "dk", "dv"), grads):
        assert np.isfinite(got[name]).all(), name
        _allclose(got[name], w, 1e-3, 1e-5, name)


def test_ring_bf16_lse(ranks):
    """Under bf16 operands the port's ring (f32 merge) gives the LSE of the
    f32 logsumexp of the same bf16 inputs within 1e-5 of max(1, |lse|), on
    every group size: the Hopper gate admits the blocks (counted hits; on
    the CPU the wrappers compute the plain versions)."""
    n, res = ranks
    case = _case("bf16")
    got = res[0]["bf16"]
    q, k = (_torch(case[x], "bfloat16") for x in ("q", "k"))
    want = A.attention_reference_lse(q.float(), k.float(), causal=True)
    err = np.abs(got["lse"] - want.numpy())
    assert (err <= 1e-5 * np.maximum(1, np.abs(want.numpy()))).all(), \
        err.max()
    assert got["counters"] == ({"ring_attention": 2}, {})


def test_reference_ring_carry_fault():
    """ROADMAP Queue 3: under bf16 the JAX ring carries (acc, l, m) in
    bf16 and rounds each block's statistics to it, so its LSE lands about
    0.06 off the f32 logsumexp of the same bf16 inputs; the port's ring
    (f32 carry) and the JAX flash path stay within 1e-5 of max(1, |lse|)."""
    case = _case("bf16")
    q, k, v = (_jnp(case[x], "bfloat16") for x in ("q", "k", "v"))
    want = np.asarray(jring.attention_reference_lse(
        q.astype(jnp.float32), k.astype(jnp.float32), causal=True))
    bound = 1e-5 * np.maximum(1, np.abs(want))
    faults = []
    for n in (1, 4):
        _, jax_ring_lse = jring.ring_attention_sharded(
            q, k, v, jax_mesh.make_mesh((n,), ("sp",)), causal=True,
            use_flash=True, return_lse=True)
        faults.append(np.abs(np.asarray(jax_ring_lse) - want).max())
    _, jax_flash_lse = pallas_attention._forward(q, k, v, True,
                                                 return_lse=True)
    _, port_lse = R.ring_attention_sharded(
        *(_torch(case[x], "bfloat16") for x in ("q", "k", "v")),
        make_mesh((1,), ("sp",)), causal=True, use_flash=True,
        return_lse=True)
    flash_err = np.abs(np.asarray(jax_flash_lse) - want)
    port_err = np.abs(port_lse.numpy() - want)
    print(f"max |LSE error| against the f32 logsumexp (max |lse| "
          f"{np.abs(want).max():.3g}): JAX ring on 1 and 4 devices "
          f"{faults[0]:.3g}, {faults[1]:.3g}; JAX flash {flash_err.max():.3g}; "
          f"the port's ring {port_err.max():.3g}")
    assert all(0.02 <= f <= 0.1 for f in faults), faults
    assert (flash_err <= bound).all() and (port_err <= bound).all()


def _jax_op(case, mesh, grads):
    """tests/test_ring_attention.py TestAttentionOpInProgram's program in
    the JAX package, on `mesh` (sequence_parallel) or on one device."""
    shape = case["q"].shape
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        qkv = []
        for n in ("q", "k", "v"):
            var = jfluid.layers.data(name=n, shape=list(shape),
                                     dtype="float32", append_batch_size=False)
            if grads:
                var.stop_gradient = False
                var.desc.stop_gradient = False
            qkv.append(var)
        out = jfluid.layers.fused_attention(
            *qkv, causal=True, sequence_parallel=mesh is not None)
        fetch = [out]
        if grads:
            loss = jfluid.layers.mean(jfluid.layers.elementwise_mul(out, out))
            jfluid.backward.append_backward(loss)
            sdpa, = [op for op in main.global_block().ops
                     if op.type == "scaled_dot_product_attention"]
            fetch = [n + "@GRAD" for n in ("q", "k", "v")] + \
                [sdpa.output("LSE")[0]]
    if mesh is not None:
        main._mesh = mesh
    with jax_executor.scope_guard(jax_executor.Scope()):
        got = jfluid.Executor(jfluid.CPUPlace()).run(
            main, feed={n: case[n] for n in ("q", "k", "v")},
            fetch_list=fetch)
    return [np.asarray(g) for g in got]


def test_program_level_ring_matches_single(ranks):
    """The op in a program with sequence_parallel=True on an 'sp' mesh
    against the JAX package's program on one device, forward."""
    n, res = ranks
    single, = _jax_op(_case("op"), None, False)
    _allclose(res[0]["op"]["out0"], single, 2e-5, 2e-6, "out")


def test_program_ring_grads_match_single_and_lse_is_real(ranks):
    """append_backward through the op: the flash ring's explicit grad op
    (direct from the saved Out and LSE) against the JAX single-device
    grads, and the ring's LSE is the real logsumexp."""
    n, res = ranks
    *want, want_lse = _jax_op(_case("op_grads"), None, True)
    got = res[0]["op_grads"]
    for i, w in enumerate(want):
        _allclose(got[f"out{i}"], w, 1e-3, 1e-5, "dqkv"[i:i + 2])
    assert not np.allclose(got["out3"], 0.0)
    _allclose(got["out3"], want_lse, 1e-4, 1e-4, "lse")
    hits, fallbacks = got["counters"]
    assert fallbacks == {("scaled_dot_product_attention", "dtype"): 1,
                         ("scaled_dot_product_attention_grad", "dtype"): 1}


def test_ranks_agree(ranks):
    """Global view: every rank ends with the same outputs, bit for bit."""
    n, res = ranks
    for r in res[1:]:
        assert r.keys() == res[0].keys()
        for name, outs in r.items():
            if name == "__place__":
                continue
            for key, val in outs.items():
                if key != "counters":
                    assert np.array_equal(val, res[0][name][key]), \
                        (name, key)


@pytest.mark.parametrize("n", [2, 4], ids=lambda n: f"P{n}")
def test_executor_default_place_is_the_rank(n, tmp_path_factory):
    """In a process group, Executor() runs on the card of its rank
    (CUDAPlace(LOCAL_RANK), the rank when no launcher set it)."""
    res = _group(n, tmp_path_factory)
    assert [r["__place__"] for r in res] == list(range(n))
    assert pt.executor.default_place() == pt.CUDAPlace(0)   # no group here


def _rl2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _zero_grads(grads):
    """The K projections' biases: grads zero in exact arithmetic, under
    1e-6 of the largest norm in JAX f32 (one per layer)."""
    norms = {p: np.linalg.norm(g) for p, g in grads.items()}
    top = max(norms.values())
    zero = {p for p, v in norms.items() if v < 1e-6 * top}
    assert len(zero) == W.LM["n_layer"]
    return zero, top


@pytest.mark.parametrize("n", [1, 4], ids=lambda n: f"P{n}")
def test_lm_ring_step_matches_jax_ring_f32(n, tmp_path_factory):
    """One Adam step of transformer_lm(sequence_parallel=True) in f32 from
    the JAX startup's weights, against the JAX ring program on a host mesh
    of the group's size: loss, grads and the state after the step."""
    _, want_loss, want, want_after = _jax_lm(False, n)
    got = _group(n, tmp_path_factory)[0]["lm"]
    assert float(got["loss"].ravel()[0]) == pytest.approx(want_loss, rel=1e-5)
    zero, top = _zero_grads(want)
    for p, w in want.items():
        g = got[f"grad/{p}"]
        if p in zero:
            assert np.linalg.norm(g) <= 1e-6 * top, p
        else:
            assert _rl2(g, w) <= 1e-5, p
    kind_top = {k: max(np.abs(w).max() for m, w in want_after.items()
                       if m.endswith(k)) for k in ("_moment1_0", "_moment2_0")}
    for m, w in want_after.items():
        kind = m[m.rfind("_moment"):]
        tol = 1e-4 * kind_top[kind] if kind in kind_top else \
            1e-5 * np.abs(w).max() + 1e-5
        assert np.abs(got[f"after/{m}"] - w).max() <= tol, m
    hits, fallbacks = got["counters"]
    assert fallbacks == {("scaled_dot_product_attention", "dtype"): 2,
                         ("scaled_dot_product_attention_grad", "dtype"): 2}


def test_lm_ring_step_o2_matches_jax_flash():
    """One Adam step under AMP O2 of the ring program on one rank against
    the JAX flash program without 'sp' (the same computation with f32
    statistics; the JAX ring in O2 carries bf16, ROADMAP Queue 3), held to
    the tolerances of the port's flash program in
    test_torch_transformer.py."""
    _, _, ref32, _ = _jax_lm(False, None)
    init, want_loss, want, _ = _jax_lm(True, None)
    A.COUNTERS.reset()
    got = W.run_lm_step(pt, make_mesh((1,), ("sp",)),
                        {"amp": True, "init": init, "feed": _lm_feed()})
    assert A.COUNTERS.hits == {"scaled_dot_product_attention": 2,
                               "scaled_dot_product_attention_grad": 2}
    assert not A.COUNTERS.fallbacks
    assert float(got["loss"].ravel()[0]) == pytest.approx(want_loss, rel=1e-3)
    zero, top = _zero_grads(ref32)
    for p, w in want.items():
        g = got[f"grad/{p}"]
        if p in zero:
            assert np.linalg.norm(g) <= 1e-5 * top, p
            continue
        assert _rl2(g, w) <= 2 * _rl2(w, ref32[p]), p
        assert abs(np.linalg.norm(g) / np.linalg.norm(w) - 1) <= 0.01, p


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "O2"])
def test_ring_program_desc_matches_jax(amp):
    """transformer_lm(sequence_parallel=True) after Adam.minimize (and
    amp.decorate O2): main and startup ProgramDescs JSON-identical in both
    packages, the op's sequence_parallel attribute included."""
    jmain, jstartup, _ = W.lm_program(jfluid, jax_models, amp, True)
    pmain, pstartup, _ = W.lm_program(pt, pt.models, amp, True)
    assert json.loads(pmain.desc.to_json()) == json.loads(jmain.desc.to_json())
    assert json.loads(pstartup.desc.to_json()) == \
        json.loads(jstartup.desc.to_json())
    sdpa = [op for op in pmain.global_block().ops
            if op.type == "scaled_dot_product_attention"]
    assert len(sdpa) == W.LM["n_layer"]
    assert all(op.attr("sequence_parallel") for op in sdpa)


# --- routing, the mesh and the collectives on one rank ------------------------

def test_untileable_shards_take_the_counted_einsum_ring():
    """T = 12 splits into no tileable shard: the einsum ring runs, counted
    as a "shard_shape" fallback, and matches one device."""
    q, k, v = (torch.from_numpy(a) for a in _arrays((1, 12, 2, 8), 3, 5))
    mesh = make_mesh((1,), ("sp",))
    assert not R.flash_ring_eligible(q, mesh)
    A.COUNTERS.reset()
    out = R.ring_attention_sharded(q, k, v, mesh, causal=True, use_flash=True)
    assert A.COUNTERS.fallbacks == {("ring_attention", "shard_shape"): 1}
    _allclose(out, A.attention_reference(q, k, v, causal=True), 2e-5, 2e-6,
              "out")


def test_sequence_parallel_without_a_mesh_takes_the_flash_path():
    """As in the reference (nn_ops.py:838): sequence_parallel=True on a
    program with no 'sp' mesh runs the flash or einsum path."""
    case = _case("op")
    main, fetch = W.attention_program(pt, case["q"].shape, True, None, False)
    A.COUNTERS.reset()
    got, = pt.Executor(pt.CPUPlace()).run(
        main, feed={n: case[n] for n in ("q", "k", "v")}, fetch_list=fetch,
        scope=pt.Scope())
    single, = _jax_op(case, None, False)
    _allclose(got, single, 2e-5, 2e-6, "out")
    assert not A.COUNTERS.fallbacks and not A.COUNTERS.hits   # einsum, T 32


def test_mesh_and_program_state():
    """make_mesh without a process group is this process's one device;
    a mesh of more ranks than the group raises; clone carries the mesh and
    the feed layouts; the lowering context exposes the mesh; the
    collectives are the identity on one rank."""
    from paddle_tpu_torch.executor import LoweringContext
    from paddle_tpu_torch.parallel import _collectives as C
    mesh = make_mesh((1,), ("sp",))
    assert (mesh.size, mesh.rank, mesh.axis_index("sp")) == (1, 0, 0)
    with pytest.raises(ValueError, match="ranks"):
        make_mesh((4,), ("sp",))
    prog = pt.Program()
    assert prog._mesh is None
    prog._mesh = mesh
    pt.parallel.shard_feed(prog, "tok", (None, "sp"))
    clone = prog.clone()
    assert clone._mesh is mesh and clone._feed_shardings == {
        "tok": (None, "sp")}
    clone._feed_shardings["x"] = ()
    assert "x" not in prog._feed_shardings
    ctx = LoweringContext(pt.Executor(pt.CPUPlace()), prog, 0)
    assert ctx.mesh is mesh
    x = torch.arange(6.0).reshape(1, 6)
    assert C.ppermute(x, mesh, "sp") is x
    assert C.shard_seq(x, mesh) is x and C.all_gather_seq(x, mesh) is x
    assert pt.parallel.replicated(mesh).spec == ()
    # the mesh's device is the card Executor() would take, else the CPU
    assert mesh.device == (pt.executor.place_device(
        pt.executor.default_place()) if torch.cuda.is_available()
        else torch.device("cpu"))
    assert pt.parallel.get_mesh() is None
    pt.parallel.set_mesh(mesh)
    try:
        assert pt.parallel.get_mesh() is mesh
    finally:
        pt.parallel.set_mesh(None)
