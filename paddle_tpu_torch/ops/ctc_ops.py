"""CTC: the warpctc loss, ctc_align's greedy decode and edit_distance (the
port's counterpart of paddle_tpu/ops/ctc_ops.py; reference warpctc_op.cc,
ctc_align_op.h, edit_distance_op.h).

The CTC forward (alpha) recursion runs in log space a step at a time over
the padded time axis, for the whole batch at once; its grad is the
generic one. Sequences are padded with their lengths beside them
(@SEQLEN), as everywhere in the port.
"""

from __future__ import annotations

import torch

from .common import in_var, seq_lengths, set_out
from .registry import NO_GRAD, op

_NEG_INF = -1e30


def _lse3(a1, a2, a3):
    m = torch.maximum(torch.maximum(a1, a2), a3)
    return m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m)
                         + torch.exp(a3 - m))


def _ctc_loss(logp, labels, t_len, l_len, blank):
    """-log p(labels | logp) per sequence (JAX ctc_ops.py:24, batched):
    logp [B, T, C] log-softmax, labels [B, L] padded, lengths [B]."""
    bsz, t_max, _c = logp.shape
    l_max = labels.shape[1]
    s_max = 2 * l_max + 1
    dev = logp.device
    z = torch.full((bsz, s_max), blank, dtype=torch.int64, device=dev)
    z[:, 1::2] = labels
    pos = torch.arange(s_max, device=dev)
    z_m2 = torch.roll(z, 2, dims=1)
    allow_skip = (z != blank) & (z != z_m2) & (pos >= 2)[None, :]
    neg = torch.full((), _NEG_INF, dtype=logp.dtype, device=dev)
    alpha = torch.full((bsz, s_max), _NEG_INF, dtype=logp.dtype, device=dev)
    alpha[:, 0] = logp[:, 0, blank]
    alpha[:, 1] = torch.where(l_len > 0, logp[:, 0].gather(1, z[:, 1:2])[:, 0],
                              neg)
    pad1 = torch.full((bsz, 1), _NEG_INF, dtype=logp.dtype, device=dev)
    pad2 = torch.full((bsz, 2), _NEG_INF, dtype=logp.dtype, device=dev)
    for s in range(1, t_max):
        a2 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a3 = torch.where(allow_skip, torch.cat([pad2, alpha[:, :-2]], dim=1),
                         neg)
        new = _lse3(alpha, a2, a3) + logp[:, s].gather(1, z)
        alpha = torch.where((s < t_len)[:, None], new, alpha)
    l_len = l_len.to(torch.int64)
    end1 = alpha.gather(1, (2 * l_len)[:, None])[:, 0]
    end2 = torch.where(l_len > 0, alpha.gather(
        1, (2 * l_len - 1).clamp(min=0)[:, None])[:, 0], neg)
    m = torch.maximum(end1, end2)
    return -(m + torch.log(torch.exp(end1 - m) + torch.exp(end2 - m)))


def _warpctc_infer(op_, block):
    xv = in_var(op_, block, "Logits")
    if xv is not None and xv.shape is not None:
        set_out(op_, block, "Loss", [xv.shape[0], 1], xv.dtype)


@op("warpctc", infer_shape=_warpctc_infer, non_diff_inputs=("Label",))
def _warpctc(ctx, op_, ins):
    """The CTC loss [B, 1] (JAX ctc_ops.py:72): Logits padded [B, T, C],
    Label padded [B, L]; the softmax is taken inside, as warp-ctc does.
    With norm_by_times the gradient is scaled by 1/T_b and the loss is
    unchanged (the reference scales the logits' grad)."""
    logits = ins["Logits"][0]
    labels = ins["Label"][0].to(torch.int64)
    if labels.dim() == 3:
        labels = labels[..., 0]
    b, t, _ = logits.shape
    t_lens = seq_lengths(ctx, op_, "Logits", b, t)
    l_lens = seq_lengths(ctx, op_, "Label", b, labels.shape[1])
    if op_.attr("norm_by_times", False):
        s = (1.0 / t_lens.clamp(min=1).to(logits.dtype))[:, None, None]
        logits = logits * s + (logits * (1.0 - s)).detach()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    loss = _ctc_loss(logp, labels, t_lens, l_lens, op_.attr("blank", 0))
    ctx.set_seq_len(op_.desc.outputs["Loss"][0], None)
    return {"Loss": [loss.to(logits.dtype)[:, None]]}


def _ctc_align_infer(op_, block):
    xv = in_var(op_, block, "Input")
    if xv is not None:
        set_out(op_, block, "Output", xv.shape, xv.dtype)


@op("ctc_align", infer_shape=_ctc_align_infer, grad=NO_GRAD)
def _ctc_align(ctx, op_, ins):
    """Greedy CTC decode (JAX ctc_ops.py:109): repeats merged, blanks
    dropped; the kept tokens moved to the front by a stable sort on the
    keep mask, with the new lengths."""
    x = ins["Input"][0]
    squeeze = x.dim() == 3
    if squeeze:
        x = x[..., 0]
    b, t = x.shape
    lens = seq_lengths(ctx, op_, "Input", b, t)
    blank = op_.attr("blank", 0)
    steps = torch.arange(t, device=x.device)[None, :]
    valid = steps < lens[:, None]
    prev = torch.cat([torch.full((b, 1), -1, dtype=x.dtype, device=x.device),
                      x[:, :-1]], dim=1)
    keep = (x != blank) & valid
    if op_.attr("merge_repeated", True):
        keep = keep & (x != prev)
    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True).indices
    out = x.gather(1, order)
    new_lens = keep.sum(dim=1).to(torch.int32)
    out = torch.where(steps < new_lens[:, None], out, torch.zeros_like(out))
    if squeeze:
        out = out[..., None]
    ctx.set_seq_len(op_.desc.outputs["Output"][0], new_lens)
    return {"Output": [out]}


def _edit_distance_infer(op_, block):
    hv = in_var(op_, block, "Hyps")
    if hv is not None and hv.shape is not None:
        set_out(op_, block, "Out", [hv.shape[0], 1], "float32")
        set_out(op_, block, "SequenceNum", [1], "int32")


@op("edit_distance", infer_shape=_edit_distance_infer, grad=NO_GRAD)
def _edit_distance(ctx, op_, ins):
    """Levenshtein distance per (hypothesis, reference) pair [B, 1] float,
    divided by the reference length with `normalized` (JAX
    ctc_ops.py:176): the DP over the padded buffers, row by row, for the
    whole batch; each pair reads its own dp[m, n]."""
    hyp, ref = ins["Hyps"][0], ins["Refs"][0]
    if hyp.dim() == 3:
        hyp = hyp[..., 0]
    if ref.dim() == 3:
        ref = ref[..., 0]
    b, l1 = hyp.shape
    l2 = ref.shape[1]
    m = seq_lengths(ctx, op_, "Hyps", b, l1).to(torch.int64)
    n = seq_lengths(ctx, op_, "Refs", b, l2).to(torch.int64)
    dev = hyp.device
    row = torch.arange(l2 + 1, dtype=torch.float32,
                       device=dev).expand(b, l2 + 1)
    rows = [row]
    for i in range(1, l1 + 1):
        cost = (hyp[:, i - 1:i] != ref).to(torch.float32)       # [B, L2]
        diag = row[:, :-1] + cost
        up = row[:, 1:] + 1.0
        cur = [torch.full((b,), float(i), device=dev)]
        for j in range(l2):
            cur.append(torch.minimum(torch.minimum(up[:, j], cur[-1] + 1.0),
                                     diag[:, j]))
        row = torch.stack(cur, dim=1)
        rows.append(row)
    table = torch.stack(rows, dim=1)                          # [B, L1+1, L2+1]
    dist = table[torch.arange(b, device=dev), m, n]
    dist = torch.where(m == 0, n.to(torch.float32), dist)
    dist = torch.where((n == 0) & (m != 0), m.to(torch.float32), dist)
    if op_.attr("normalized", False):
        dist = dist / n.clamp(min=1).to(torch.float32)
    for name in op_.desc.outputs.get("Out", []):
        ctx.set_seq_len(name, None)
    return {"Out": [dist[:, None]],
            "SequenceNum": [torch.full((1,), b, dtype=torch.int32,
                                       device=dev)]}
