"""Linear-chain CRF on padded sequences (the port's counterpart of
paddle_tpu/ops/crf_ops.py; reference linear_chain_crf_op.cc,
crf_decoding_op.cc).

The forward recursion runs in the log domain, a step at a time over the
padded time axis; its grad is the generic one (the recursion re-run under
autograd, counted in `registry.RERUNS["linear_chain_crf"]`). Viterbi keeps
each step's argmax (the first index among ties, as `jnp.argmax` takes
it) and backtracks from each sequence's last valid step. Transition is
[D+2, D]: the start row, the stop row, then the pairwise matrix.
"""

from __future__ import annotations

import torch

from .common import in_var, set_out
from .registry import NO_GRAD, op


def _crf_infer(op_, block):
    ev = in_var(op_, block, "Emission")
    if ev is not None and ev.shape is not None:
        set_out(op_, block, "LogLikelihood", [ev.shape[0], 1], ev.dtype)


def _lengths(ctx, op_, emission):
    names = op_.desc.inputs.get("Emission", [])
    lengths = ctx.seq_len(names[0]) if names else None
    if lengths is None:
        return torch.full((emission.shape[0],), emission.shape[1],
                          dtype=torch.int32, device=emission.device)
    return lengths


@op("linear_chain_crf", infer_shape=_crf_infer, non_diff_inputs=("Label",))
def _linear_chain_crf(ctx, op_, ins):
    """-log p(label path | emission) per sequence, [B, 1] (JAX
    crf_ops.py:37): Emission [B, T, D] padded, Label [B, T, 1] int."""
    emission = ins["Emission"][0]
    transition = ins["Transition"][0]
    label = ins["Label"][0].to(torch.int64)
    if label.dim() == 3:
        label = label[..., 0]
    bsz, t, _d = emission.shape
    start, stop, trans = transition[0], transition[1], transition[2:]
    lengths = _lengths(ctx, op_, emission)
    mask = (torch.arange(t, device=emission.device)[None, :]
            < lengths[:, None]).to(emission.dtype)
    alpha = start[None, :] + emission[:, 0]
    for s in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + emission[:, s]
        m = mask[:, s, None]
        alpha = m * nxt + (1 - m) * alpha
    log_z = torch.logsumexp(alpha + stop[None, :], dim=1)
    emit = emission.gather(2, label[..., None])[..., 0]
    emit_sum = (emit * mask).sum(dim=1)
    pair = trans[label[:, :-1], label[:, 1:]]
    pair_sum = (pair * mask[:, 1:]).sum(dim=1)
    last = (lengths.to(torch.int64) - 1).clamp(min=0)
    last_label = label.gather(1, last[:, None])[:, 0]
    path = start[label[:, 0]] + emit_sum + pair_sum + stop[last_label]
    for name in op_.desc.outputs.get("LogLikelihood", []):
        ctx.set_seq_len(name, None)
    return {"LogLikelihood": [(log_z - path)[:, None]]}


def _decode_infer(op_, block):
    ev = in_var(op_, block, "Emission")
    if ev is not None and ev.shape is not None:
        set_out(op_, block, "ViterbiPath", list(ev.shape[:2]) + [1], "int64")


@op("crf_decoding", infer_shape=_decode_infer, grad=NO_GRAD)
def _crf_decoding(ctx, op_, ins):
    """Viterbi (JAX crf_ops.py:95): the best path [B, T, 1] int64, zero
    past each length; with a Label, 1 where the path's tag is the gold
    tag (inside the length) and 0 elsewhere."""
    emission = ins["Emission"][0]
    transition = ins["Transition"][0]
    _bsz, t, _d = emission.shape
    start, stop, trans = transition[0], transition[1], transition[2:]
    lengths = _lengths(ctx, op_, emission)
    mask = torch.arange(t, device=emission.device)[None, :] \
        < lengths[:, None]
    delta = start[None, :] + emission[:, 0]
    backs = []
    for s in range(1, t):
        cand = delta[:, :, None] + trans[None]                  # [B, D, D]
        back = torch.argmax(cand, dim=1)                        # [B, D]
        best = cand.gather(1, back[:, None, :])[:, 0] + emission[:, s]
        delta = torch.where(mask[:, s, None], best, delta)
        backs.append(back)
    tag = torch.argmax(delta + stop[None, :], dim=1)            # [B]
    path = [tag]
    for s in range(t - 1, 0, -1):
        prev = backs[s - 1].gather(1, tag[:, None])[:, 0]
        tag = torch.where(mask[:, s], prev, tag)
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)                       # [B, T]
    path = torch.where(mask, path, torch.zeros_like(path))[..., None]
    result = path
    if ins.get("Label") and ins["Label"][0] is not None:
        label = ins["Label"][0].to(torch.int64)
        if label.dim() == 2:
            label = label[..., None]
        result = ((path == label) & mask[..., None]).to(torch.int64)
    for name in op_.desc.outputs.get("ViterbiPath", []):
        ctx.set_seq_len(name, lengths)
    return {"ViterbiPath": [result]}
