"""Program-level pipeline parallelism (the port's counterpart of
paddle_tpu/parallel/program_pipeline.py): split a fluid Program into stage
sub-programs on the IR and train them under a GPipe microbatch schedule.

The user names the boundary (cut) variables; each stage becomes a pruned
sub-program (`Program.prune`, scoped to that stage's slice, its reads
collected through sub-blocks by `op_external_reads`), its gradient program
the stage's forward plus an IR-level vjp (`append_backward` on the last
stage, `calc_gradient` with the boundary cotangent as `target_gradients`
elsewhere), and its update program the optimizer's pass over the stage's
parameters with their `optimize_attr`, regularizer and clip carried over.
A step runs the classic GPipe schedule: every microbatch forward in tick
order across the stages' executors, then backward in reverse, the
gradients averaged over the microbatches and applied.

Placement: stage i runs on `places[i % len(places)]`, by default
CUDAPlace(i mod the cards visible), so with one card every stage shares
card 0. Boundary tensors stay on the device (`return_numpy=False`); where
two stages sit on different devices a boundary tensor or cotangent is
moved to the next stage's device explicitly, counted in
`COUNTERS.moves` and `COUNTERS.moved_bytes`.

Numerics contract: with per-microbatch mean losses and equal microbatch
sizes, the mean of the microbatch gradients is the full batch's, so the
losses match one-device training up to the order of sums.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["PipelineTranspiler", "PipelineTrainer", "COUNTERS"]


@dataclass
class Counters:
    """moves: boundary tensors (activations or cotangents) moved between
    two stages' devices; moved_bytes: their bytes; runs: stage program
    runs, by kind ('fwd', 'grad', 'update')."""
    moves: int = 0
    moved_bytes: int = 0
    runs: Dict[str, int] = field(default_factory=dict)

    def reset(self):
        self.moves = self.moved_bytes = 0
        self.runs = {}


COUNTERS = Counters()


def _var_names(v_or_list):
    from ..framework.framework import Variable
    if isinstance(v_or_list, (list, tuple)):
        return [v.name if isinstance(v, Variable) else str(v)
                for v in v_or_list]
    v = v_or_list
    return [v.name if isinstance(v, Variable) else str(v)]


class _Stage:
    def __init__(self, idx, fwd_prog, grad_prog, update_prog, update_startup,
                 in_name, out_name, feed_names, param_names, grad_feed_name,
                 place):
        self.idx = idx
        self.fwd_prog = fwd_prog            # feeds -> out boundary (+loss)
        self.grad_prog = grad_prog          # feeds + cotangent -> grads
        self.update_prog = update_prog      # grad feeds -> param updates
        self.update_startup = update_startup
        self.in_name = in_name              # boundary var consumed (or None)
        self.out_name = out_name            # boundary var produced (or loss)
        self.feed_names = feed_names        # data vars this stage consumes
        self.param_names = param_names
        self.grad_feed_name = grad_feed_name  # cotangent feed (None on last)
        self.place = place


def default_places(n_stages: int):
    """CUDAPlace(i mod the cards visible) for stage i."""
    from ..executor import CUDAPlace
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return [CUDAPlace(i % max(cards, 1)) for i in range(n_stages)]


class PipelineTranspiler:
    """Split a program at named cut variables into pipeline stages.

    Usage (mirrors DistributeTranspiler's transpile-then-get pattern):

        t = PipelineTranspiler()
        trainer = t.transpile(loss, cut_vars=[h1, h2, h3],
                              optimizer=lambda: fluid.optimizer.SGD(0.1),
                              num_microbatches=4)
        trainer.startup(startup_program)
        loss_val = trainer.train_step(feed={"x": ..., "y": ...})

    cut_vars define P = len(cut_vars)+1 stages: stage i computes from cut
    i-1 (or the feeds) up to cut i; the last stage ends at the loss.
    """

    def transpile(self, loss, cut_vars: Sequence, optimizer: Callable,
                  num_microbatches: int, main_program=None,
                  places: Optional[Sequence] = None):
        from .. import layers
        from ..backward import append_backward, calc_gradient
        from ..clip import append_gradient_clip_ops
        from ..framework.framework import (Parameter, Program, grad_var_name,
                                           op_external_reads, program_guard)
        from ..regularizer import append_regularization_ops

        program = main_program or loss.block.program
        cut_names = _var_names(list(cut_vars))
        loss_name = loss.name
        block = program.global_block()
        src_params = {p.name: p for p in block.all_parameters()}
        param_names_all = set(src_params)
        # non-trainable params stay frozen: excluded from grads and updates
        # exactly like append_backward's trainable filter in minimize()
        trainable = {n for n, p in src_params.items()
                     if getattr(p, "trainable", True)}
        data_names = self._feed_var_names(program)

        n_stages = len(cut_names) + 1
        boundaries = [None] + cut_names              # input boundary per stage
        targets = cut_names + [loss_name]            # output per stage
        places = list(places) if places else default_places(n_stages)

        stages: List[_Stage] = []
        for i in range(n_stages):
            in_name = boundaries[i]
            out_name = targets[i]
            feeds = ([in_name] if in_name else []) + list(data_names) \
                + sorted(param_names_all)
            fwd = program.prune(feeds=feeds, fetches=[out_name])
            fblock = fwd.global_block()
            # reads through sub-blocks: a param or feed read only inside a
            # loop body still belongs to the stage
            stage_reads = set()
            for op in fblock.ops:
                stage_reads |= op_external_reads(fwd, op)
            stage_params = sorted(stage_reads & trainable)
            stage_feeds = sorted(stage_reads & set(data_names))

            # gradient program: stage forward + IR-level vjp
            grad = fwd.clone()
            gblock = grad.global_block()
            grad_feed_name = None
            with program_guard(grad):
                if i == n_stages - 1:
                    append_backward(gblock.var(out_name))
                else:
                    gvar = layers.data(
                        name=f"{out_name}@PIPE_CT", shape=[1],
                        dtype=gblock.var(out_name).dtype,
                        append_batch_size=False, stop_gradient=True)
                    grad_feed_name = gvar.name
                    wrt = ([in_name] if in_name else []) + stage_params
                    calc_gradient(gblock.var(out_name),
                                  [gblock.var(n) for n in wrt],
                                  target_gradients=gvar)

            # optimizer-update program: grads arrive as feeds
            update = Program()
            update_startup = Program()
            with program_guard(update, update_startup):
                ublock = update.global_block()
                pg = []
                for pn in stage_params:
                    src = src_params[pn]
                    p = Parameter(ublock, name=pn, shape=src.shape,
                                  dtype=src.dtype)
                    # per-param optimizer semantics survive the rebuild
                    # (lr scale, weight decay, clipping)
                    p.trainable = getattr(src, "trainable", True)
                    p.optimize_attr = dict(
                        getattr(src, "optimize_attr", None)
                        or {"learning_rate": 1.0})
                    p.regularizer = getattr(src, "regularizer", None)
                    p.gradient_clip_attr = getattr(
                        src, "gradient_clip_attr", None)
                    g = ublock.create_var(name=grad_var_name(pn),
                                          shape=src.shape, dtype=src.dtype)
                    pg.append((p, g))
                if pg:
                    opt = optimizer()
                    # the post-processing minimize() applies
                    pg = append_gradient_clip_ops(pg)
                    pg = append_regularization_ops(pg, opt.regularization)
                    opt._create_optimization_pass(pg, pg[0][0],
                                                  update_startup)
            stages.append(_Stage(i, fwd, grad, update, update_startup,
                                 in_name, out_name, stage_feeds,
                                 stage_params, grad_feed_name,
                                 places[i % len(places)]))

        # cut vars must be graph separators: a param reachable from two
        # stages (a skip connection across a cut, or cuts out of
        # topological order) would get its update applied once per owning
        # stage — rejected instead of silently double-stepping
        seen: Dict[str, int] = {}
        for s in stages:
            for pn in s.param_names:
                if pn in seen:
                    raise ValueError(
                        f"Parameter '{pn}' is used by pipeline stages "
                        f"{seen[pn]} and {s.idx}: the cut variables "
                        f"{cut_names} do not separate the graph (skip "
                        f"connection across a cut?). Choose cuts so every "
                        f"parameter belongs to exactly one stage.")
                seen[pn] = s.idx
        return PipelineTrainer(stages, num_microbatches, loss_name)

    @staticmethod
    def _feed_var_names(program) -> List[str]:
        """Data vars = root-block vars nobody produces and that are not
        parameters/persistable (the feed surface), their reads collected
        through sub-blocks."""
        from ..framework.framework import op_external_reads
        block = program.global_block()
        produced = {n for op in block.ops for n in op.output_arg_names}
        params = {p.name for p in block.all_parameters()}
        reads = set()
        for op in block.ops:
            reads |= op_external_reads(program, op)
        names = []
        for name in block.desc.vars:
            v = block.var(name)
            if name in produced or name in params:
                continue
            if getattr(v.desc, "persistable", False):
                continue
            if name in reads:
                names.append(name)
        return names


def _to(t, device):
    """`t` on `device`; a move between two devices is counted."""
    if not isinstance(t, torch.Tensor) or t.device == device:
        return t
    COUNTERS.moves += 1
    COUNTERS.moved_bytes += t.numel() * t.element_size()
    return t.to(device)


class PipelineTrainer:
    """GPipe execution of transpiled stages: forward all microbatches in
    tick order, backward reversed, average grads, apply updates."""

    def __init__(self, stages: List[_Stage], num_microbatches: int,
                 loss_name: str):
        from ..executor import Executor
        self.stages = stages
        self.m = num_microbatches
        self.loss_name = loss_name
        self.executors = [Executor(s.place) for s in stages]

    def startup(self, startup_program, scope=None):
        """Run the model's startup once (params init) + each stage's
        optimizer-startup (accumulators, lr vars)."""
        self.executors[0].run(startup_program, scope=scope)
        for s, exe in zip(self.stages, self.executors):
            exe.run(s.update_startup, scope=scope)

    def _split_feed(self, feed: Dict[str, object]):
        from ..executor import LoDTensor
        m = self.m
        micro = [dict() for _ in range(m)]
        for name, val in feed.items():
            if isinstance(val, LoDTensor):
                # a LoD feed's packed rows cannot be row-sliced into
                # microbatches without splitting sequences mid-way
                raise ValueError(
                    f"Pipeline microbatching does not support LoDTensor "
                    f"feeds yet ('{name}'): pre-pad sequence feeds to "
                    f"dense [batch, time, ...] arrays")
            assert val.shape[0] % m == 0, (
                f"batch {val.shape[0]} not divisible into {m} microbatches")
            step = val.shape[0] // m
            for j in range(m):
                micro[j][name] = val[j * step: (j + 1) * step]
        return micro

    def _run(self, kind, si, prog, feed, fetch, scope, use_jit):
        COUNTERS.runs[kind] = COUNTERS.runs.get(kind, 0) + 1
        exe = self.executors[si]
        feed = {k: _to(v, exe.device) for k, v in feed.items()}
        return exe.run(prog, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False, use_jit=use_jit)

    def train_step(self, feed: Dict[str, object], scope=None,
                   use_jit=None):
        """One synchronized pipeline step over the full batch; returns the
        mean loss across microbatches. `use_jit` goes to every stage
        program's Executor.run (False: eager, no CUDA graphs)."""
        from ..framework.framework import grad_var_name

        stages, m = self.stages, self.m
        p = len(stages)
        micro = self._split_feed(feed)

        # forward in GPipe tick order
        acts = [[None] * p for _ in range(m)]   # boundary outputs
        losses = [None] * m
        for t in range(m + p - 1):
            for si in range(p):
                j = t - si
                if not (0 <= j < m):
                    continue
                s = stages[si]
                f = {k: v for k, v in micro[j].items()
                     if k in s.feed_names}
                if s.in_name:
                    f[s.in_name] = acts[j][si - 1]
                out, = self._run("fwd", si, s.fwd_prog, f, [s.out_name],
                                 scope, use_jit)
                acts[j][si] = out
                if si == p - 1:
                    losses[j] = out

        # backward: reverse ticks; cotangents flow right-to-left
        grad_acc: Dict[str, object] = {}
        cts = [None] * m                         # cotangent entering stage si
        for t in range(m + p - 1):
            for si in range(p - 1, -1, -1):
                j = t - (p - 1 - si)
                if not (0 <= j < m):
                    continue
                s = stages[si]
                f = {k: v for k, v in micro[j].items()
                     if k in s.feed_names}
                if s.in_name:
                    f[s.in_name] = acts[j][si - 1]
                if s.grad_feed_name:
                    f[s.grad_feed_name] = cts[j]
                fetch = [grad_var_name(pn) for pn in s.param_names]
                if s.in_name:
                    fetch = [grad_var_name(s.in_name)] + fetch
                vals = self._run("grad", si, s.grad_prog, f, fetch, scope,
                                 use_jit)
                if s.in_name:
                    cts[j] = vals[0]
                    gvals = vals[1:]
                else:
                    gvals = vals
                for pn, gv in zip(s.param_names, gvals):
                    cur = grad_acc.get(pn)
                    grad_acc[pn] = gv if cur is None else cur + gv

        # apply: mean of microbatch grads == full-batch grad (mean losses)
        inv_m = 1.0 / m
        for si, s in enumerate(stages):
            if not s.param_names:
                continue
            gfeed = {grad_var_name(pn): grad_acc[pn] * inv_m
                     for pn in s.param_names}
            self._run("update", si, s.update_prog, gfeed, [], scope,
                      use_jit)

        return float(np.mean([float(l.reshape(-1)[0]) for l in losses]))
