"""Beam search on dense [batch, beam] lanes (the port's counterpart of
paddle_tpu/ops/beam_search_ops.py; reference beam_search_op.cc,
beam_search_decode_op.cc).

A finished lane (its last id is end_id) is frozen: its only candidate is
end_id at +0. Selection takes the K best of the K*V flat candidates of a
row by a stable descending sort, so among equal scores the lower flat
index wins, as `lax.top_k` breaks ties (frozen lanes make ties).
Backtracking builds its gather indices on the device from the arrays'
length tensor: no lowering here reads a length on the host.
"""

from __future__ import annotations

import torch

from .control_flow_ops import TensorArrayVal
from .registry import NO_GRAD, op


@op("beam_search", grad=NO_GRAD)
def _beam_search(ctx, op_, ins):
    """One decode step (JAX beam_search_ops.py:23): pre_ids [B, K] int,
    pre_scores [B, K], scores [B, K, V] next-token log-probs -> the
    selected ids (int64), cumulative scores and parent lanes (int32), each
    [B, K]."""
    pre_ids = ins["pre_ids"][0]
    pre_scores = ins["pre_scores"][0]
    scores = ins["scores"][0]
    if pre_ids.dim() == 3:
        pre_ids = pre_ids[..., 0]
    bsz, k, v = scores.shape
    if int(op_.attr("beam_size", k)) != k:
        raise ValueError("the beam lanes must number beam_size")
    end_id = int(op_.attr("end_id", 1))
    finished = pre_ids.to(torch.int64) == end_id
    # a finished lane's row: end_id at +0, every other token at the dtype's
    # least value (made on the device: no scalar copied from the host)
    frozen = torch.where(
        torch.arange(v, device=scores.device) == end_id,
        torch.zeros((), dtype=scores.dtype, device=scores.device),
        torch.full((), torch.finfo(scores.dtype).min, dtype=scores.dtype,
                   device=scores.device))
    step = torch.where(finished[..., None], frozen, scores)
    flat = (pre_scores[..., None] + step).reshape(bsz, k * v)
    top = torch.sort(flat, dim=1, descending=True, stable=True)
    top_scores, top_idx = top.values[:, :k], top.indices[:, :k]
    return {"selected_ids": [top_idx % v],
            "selected_scores": [top_scores],
            "parent_idx": [(top_idx // v).to(torch.int32)]}


@op("beam_search_decode", grad=NO_GRAD)
def _beam_search_decode(ctx, op_, ins):
    """The step arrays backtracked into hypotheses (JAX
    beam_search_ops.py:53): Ids and ParentIdx are tensor arrays of [B, K]
    steps; SentenceIds [B, K, cap] hold each lane's tokens from step 0,
    end_id past the arrays' length; SentenceScores [B, K] are the lanes'
    scores at the last step."""
    ids_arr, par_arr = ins["Ids"][0], ins["ParentIdx"][0]
    if not isinstance(ids_arr, TensorArrayVal):
        raise TypeError("beam_search_decode needs tensor arrays")
    scores_arr = ins["Scores"][0] if ins.get("Scores") else None
    end_id = int(op_.attr("end_id", 1))
    ids_buf, par_buf = ids_arr.buffer, par_arr.buffer          # [C, B, K]
    n = ids_arr.length.to(torch.int64)
    cap, bsz, k = ids_buf.shape
    dev = ids_buf.device
    lanes = torch.arange(k, device=dev).expand(bsz, k)
    toks = []                     # toks[i]: the token at step n - 1 - i
    for i in range(cap):
        step = n - 1 - i
        valid = step >= 0
        at = step.clamp(min=0).reshape(1)
        tok = ids_buf.index_select(0, at)[0].gather(1, lanes)
        par = par_buf.index_select(0, at)[0].to(torch.int64).gather(1, lanes)
        toks.append(torch.where(valid, tok.to(torch.int64),
                                torch.full_like(tok, end_id,
                                                dtype=torch.int64)))
        lanes = torch.where(valid, par, lanes)
    toks = torch.stack(toks)                                     # [C, B, K]
    # step t < n is toks[n - 1 - t]; a later step's index lands on an
    # invalid entry (end_id): the JAX package's reverse-and-roll
    t = torch.arange(cap, device=dev)
    src = cap - 1 - torch.remainder(t + cap - n, cap)
    ordered = toks.index_select(0, src)
    sentences = ordered.permute(1, 2, 0)                         # [B, K, C]
    if scores_arr is not None:
        last = (n - 1).clamp(min=0).reshape(1)
        final = scores_arr.buffer.index_select(0, last)[0]
    else:
        final = torch.zeros((bsz, k), dtype=torch.float32, device=dev)
    return {"SentenceIds": [sentences], "SentenceScores": [final]}
