"""Sequence (LoD) ops on padded dense tensors and length masks (the port's
counterpart of paddle_tpu/ops/sequence_ops.py; reference
paddle/fluid/operators/sequence_*_op.cc, lstm_op.cc, gru_op.cc,
math/lstm_compute.*, gru_compute.*, sequence_pooling.cc).

Sequences are padded dense [batch, T, D] with an int32 lengths tensor
beside them on the device (`<name>@SEQLEN`, executor.pack_to_padded), and
every op masks by length. Masks are built on the device from the lengths
(`common.time_mask`); no lowering reads a length on the host, so a step is
captured as a CUDA graph once per padded shape and each replay masks its
own batch.

The RNNs are a loop over time of one GEMM (`torch.addmm`) and the cell's
elementwise work, in the JAX package's gate layouts, which are not
torch.nn's:
  LSTM: gates [input, forget, candidate, output] along 4H; with peepholes
        a [1, 7H] bias of the gate bias, then W_ic, W_fc, W_oc.
  GRU:  weight [H, 3H] = [update, reset | candidate];
        h = u * h_prev + (1 - u) * c.
A padded step holds the carry and emits zeros. `lstm` has an explicit
grad (`lstm_grad`: back-propagation through time from the saved Hidden and
Cell, each step's gates recomputed for all steps at once); the other ops
take the generic grad, counted in registry.RERUNS.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import in_var, set_out, time_mask
from .registry import NO_GRAD, cotangent, grad_op, op, zero_grads


def _lengths(ctx, op_, slot="X", idx=0):
    names = op_.desc.inputs.get(slot, [])
    if idx < len(names):
        return ctx.seq_len(names[idx])
    return None


def _identity(x):
    return x


_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": _identity,
    "": _identity,
}

# d act(z) / dz from y = act(z), for the explicit LSTM grad
_ACT_GRADS = {
    "sigmoid": lambda y: y * (1.0 - y),
    "tanh": lambda y: 1.0 - y * y,
    "relu": lambda y: (y > 0).to(y.dtype),
    "identity": torch.ones_like,
    "": torch.ones_like,
}


def _opt(ins, slot):
    v = ins.get(slot)
    return v[0] if v and v[0] is not None else None


def _time_major(x, mask, is_reverse):
    """x [B, T, ...] -> [T, B, ...] in scan order, and the [T, B, 1] mask
    (None when every step counts)."""
    xs = x.transpose(0, 1)
    if mask is not None:
        mask = mask.transpose(0, 1).unsqueeze(-1)
    if is_reverse:
        xs = xs.flip(0)
        mask = None if mask is None else mask.flip(0)
    return xs, mask


def _batch_major(hs, is_reverse):
    if is_reverse:
        hs = hs.flip(0)
    return hs.transpose(0, 1).contiguous()


def _keep(m, new, old):
    """A padded step holds the carry: `new` where m is 1, else `old`."""
    return new if m is None else torch.where(m > 0, new, old)


def _emit(m, v):
    """A padded step emits zeros."""
    return v if m is None else v * m


def _step_mask(ctx, op_, x, slot="Input"):
    lengths = _lengths(ctx, op_, slot)
    mask = None if lengths is None else time_mask(lengths, x.shape[1], x.dtype)
    return lengths, mask


def _set_lengths(ctx, op_, slots, lengths):
    for slot in slots:
        for name in op_.desc.outputs.get(slot, []):
            ctx.set_seq_len(name, lengths)


# ---------------------------------------------------------------------------
# Fused RNNs
# ---------------------------------------------------------------------------

def _lstm_infer(op_, block):
    xv = in_var(op_, block, "Input")
    if xv is None or xv.shape is None:
        return
    b, t, h4 = xv.shape[0], xv.shape[1], xv.shape[2]
    h = h4 // 4 if h4 and h4 > 0 else None
    set_out(op_, block, "Hidden", [b, t, h], xv.dtype)
    set_out(op_, block, "Cell", [b, t, h], xv.dtype)


class _LSTMParams:
    """One lstm op's attributes and parameters as the loop uses them."""

    def __init__(self, op_, ins):
        x, w = ins["Input"][0], ins["Weight"][0]
        bias = _opt(ins, "Bias")
        self.h = h = w.shape[0]
        self.w = w
        self.peep = bool(op_.attr("use_peepholes", False))
        self.rev = bool(op_.attr("is_reverse", False))
        self.gate = op_.attr("gate_activation", "sigmoid")
        self.cell = op_.attr("cell_activation", "tanh")
        self.cand = op_.attr("candidate_activation", "tanh")
        bias = None if bias is None else bias.reshape(-1)
        self.bias = bias
        self.b_gate = None if bias is None else bias[: 4 * h]
        if self.peep:
            if bias is None or bias.shape[0] < 7 * h:
                raise ValueError("use_peepholes=True requires a Bias of width "
                                 "7*H (gate bias + W_ic|W_fc|W_oc peephole "
                                 "weights)")
            self.w_ic = bias[4 * h: 5 * h]
            self.w_fc = bias[5 * h: 6 * h]
            self.w_oc = bias[6 * h: 7 * h]
        bsz = x.shape[0]
        h0, c0 = _opt(ins, "H0"), _opt(ins, "C0")
        self.h0 = h0 if h0 is not None else x.new_zeros((bsz, h))
        self.c0 = c0 if c0 is not None else x.new_zeros((bsz, h))

    def projected(self, xs):
        """The x projection plus the gate bias, [T, B, 4H] contiguous."""
        return xs + self.b_gate if self.b_gate is not None else \
            xs.contiguous()


@op("lstm", infer_shape=_lstm_infer, non_diff_inputs=())
def _lstm(ctx, op_, ins):
    """Fused LSTM over a padded sequence (reference lstm_op.cc; JAX
    sequence_ops.py:69). Input [B, T, 4H] is the precomputed x projection;
    Weight [H, 4H] the recurrent projection; Bias [1, 4H], or [1, 7H] with
    peepholes. Each step is one addmm and the cell's elementwise ops."""
    x = ins["Input"][0]
    p = _LSTMParams(op_, ins)
    h_dim = p.h
    lengths, mask = _step_mask(ctx, op_, x)
    xs, mask = _time_major(x, mask, p.rev)
    xs = p.projected(xs)
    gate, cell, cand = _ACTS[p.gate], _ACTS[p.cell], _ACTS[p.cand]
    h, c = p.h0, p.c0
    hs, cs = [], []
    for t in range(xs.shape[0]):
        g = torch.addmm(xs[t], h, p.w)
        gi, gf, gc, go = g.split(h_dim, dim=1)
        if p.peep:
            gi = torch.addcmul(gi, c, p.w_ic)
            gf = torch.addcmul(gf, c, p.w_fc)
        c_new = torch.addcmul(gate(gf) * c, gate(gi), cand(gc))
        if p.peep:
            go = torch.addcmul(go, c_new, p.w_oc)
        h_new = gate(go) * cell(c_new)
        m = None if mask is None else mask[t]
        hs.append(_emit(m, h_new))
        cs.append(_emit(m, c_new))
        h, c = _keep(m, h_new, h), _keep(m, c_new, c)
    _set_lengths(ctx, op_, ("Hidden", "Cell"), lengths)
    return {"Hidden": [_batch_major(torch.stack(hs), p.rev)],
            "Cell": [_batch_major(torch.stack(cs), p.rev)]}


@grad_op("lstm")
def _lstm_grad(ctx, op_, ins):
    """Back-propagation through time from the forward's saved Hidden and
    Cell: each step's carried (h, c) is the emitted value of the step
    before it (or H0/C0 where no valid step came before), so the gates of
    every step are recomputed at once (one GEMM), and the loop over time
    carries only dh and dc back: per step the elementwise chain and one
    GEMM against Weight^T. The weight, bias and peephole grads are one
    reduction each after the loop. A padded step passes the carry's grad
    through and contributes nothing else, as the vjp of the masked
    forward."""
    x = ins["Input"][0]
    p = _LSTMParams(op_, ins)
    h_dim = p.h
    hid, cel = ins["Hidden"][0], ins["Cell"][0]
    d_hid = cotangent(ins, "Hidden", hid)
    d_cel = cotangent(ins, "Cell", cel)
    if d_hid is None and d_cel is None:
        return zero_grads(op_, ins)
    lengths, mask = _step_mask(ctx, op_, x)
    xs, mask = _time_major(x, mask, p.rev)
    hs, _ = _time_major(hid, None, p.rev)
    cs, _ = _time_major(cel, None, p.rev)
    t_len, bsz = xs.shape[0], xs.shape[1]
    # the carries each step started from
    h_prev, c_prev = hs[:-1], cs[:-1]
    if mask is not None:
        h_prev = h_prev + (1.0 - mask[:-1]) * p.h0
        c_prev = c_prev + (1.0 - mask[:-1]) * p.c0
    h_prev = torch.cat([p.h0[None], h_prev])
    c_prev = torch.cat([p.c0[None], c_prev])
    g = p.projected(xs) + torch.mm(h_prev.reshape(-1, h_dim), p.w).reshape(
        t_len, bsz, 4 * h_dim)
    gi, gf, gc, go = g.split(h_dim, dim=2)
    if p.peep:
        gi = gi + c_prev * p.w_ic
        gf = gf + c_prev * p.w_fc
        go = go + cs * p.w_oc
    gate, cell, cand = _ACTS[p.gate], _ACTS[p.cell], _ACTS[p.cand]
    dgate, dcell, dcand = (_ACT_GRADS[p.gate], _ACT_GRADS[p.cell],
                           _ACT_GRADS[p.cand])
    i, f, cc, o = gate(gi), gate(gf), cand(gc), gate(go)
    tc = cell(cs)
    # per-step factors that need no carry: dG_x = dct * k_x, dgo = dh * k_o
    k_i = cc * dgate(i)
    k_f = c_prev * dgate(f)
    k_c = i * dcand(cc)
    k_o = tc * dgate(o)
    k_hc = o * dcell(tc)
    d_hid_t = None if d_hid is None else _time_major(d_hid, None, p.rev)[0]
    d_cel_t = None if d_cel is None else _time_major(d_cel, None, p.rev)[0]
    dg = torch.empty_like(g)
    dh = torch.zeros_like(p.h0)
    dc = torch.zeros_like(p.c0)
    w_t = p.w.t()
    for t in range(t_len - 1, -1, -1):
        m = None if mask is None else mask[t]
        dh_new = dh if d_hid_t is None else dh + d_hid_t[t]
        dc_new = dc if d_cel_t is None else dc + d_cel_t[t]
        if m is not None:
            dh_new, dc_new = dh_new * m, dc_new * m
        dgo = dh_new * k_o[t]
        dct = torch.addcmul(dc_new, dh_new, k_hc[t])
        if p.peep:
            dct = torch.addcmul(dct, dgo, p.w_oc)
        dgi, dgf, dgc = dct * k_i[t], dct * k_f[t], dct * k_c[t]
        step = dg[t]
        step[:, :h_dim] = dgi
        step[:, h_dim:2 * h_dim] = dgf
        step[:, 2 * h_dim:3 * h_dim] = dgc
        step[:, 3 * h_dim:] = dgo
        dc_prev = dct * f[t]
        if p.peep:
            dc_prev = torch.addcmul(dc_prev, dgi, p.w_ic)
            dc_prev = torch.addcmul(dc_prev, dgf, p.w_fc)
        dh_prev = torch.mm(step, w_t)
        if m is not None:
            keep = 1.0 - m
            dc_prev = torch.addcmul(dc_prev, keep, dc)
            dh_prev = torch.addcmul(dh_prev, keep, dh)
        dh, dc = dh_prev, dc_prev
    outs = {}
    wants = op_.desc.outputs
    if "Input@GRAD" in wants:
        outs["Input@GRAD"] = [_batch_major(dg, p.rev)]
    if "Weight@GRAD" in wants:
        outs["Weight@GRAD"] = [torch.mm(h_prev.reshape(-1, h_dim).t(),
                                        dg.reshape(-1, 4 * h_dim))]
    if "Bias@GRAD" in wants and p.bias is not None:
        parts = [dg.sum(dim=(0, 1))]
        if p.peep:
            dgi_all, dgf_all = dg[..., :h_dim], dg[..., h_dim:2 * h_dim]
            dgo_all = dg[..., 3 * h_dim:]
            parts += [(dgi_all * c_prev).sum(dim=(0, 1)),
                      (dgf_all * c_prev).sum(dim=(0, 1)),
                      (dgo_all * cs).sum(dim=(0, 1))]
        db = torch.cat(parts)
        width = ins["Bias"][0].numel()
        if db.numel() < width:
            db = torch.cat([db, db.new_zeros(width - db.numel())])
        outs["Bias@GRAD"] = [db.reshape(ins["Bias"][0].shape)]
    if "H0@GRAD" in wants:
        outs["H0@GRAD"] = [dh]
    if "C0@GRAD" in wants:
        outs["C0@GRAD"] = [dc]
    return outs


def _lstmp_infer(op_, block):
    xv = in_var(op_, block, "Input")
    pv = in_var(op_, block, "ProjWeight")
    if xv is None or xv.shape is None:
        return
    b, t, h4 = xv.shape[0], xv.shape[1], xv.shape[2]
    h = h4 // 4 if h4 and h4 > 0 else None
    p = pv.shape[1] if pv is not None and pv.shape is not None else None
    set_out(op_, block, "Projection", [b, t, p], xv.dtype)
    set_out(op_, block, "Cell", [b, t, h], xv.dtype)


@op("lstmp", infer_shape=_lstmp_infer)
def _lstmp(ctx, op_, ins):
    """LSTM with a recurrent projection (reference lstmp_op.cc; JAX
    sequence_ops.py:155): the recurrent state is r = proj_act(h @
    ProjWeight) [B, P], and the gates read r, not h."""
    x, w, pw = ins["Input"][0], ins["Weight"][0], ins["ProjWeight"][0]
    bias = _opt(ins, "Bias")
    bias = None if bias is None else bias.reshape(-1)
    h_dim, p_dim = pw.shape
    bsz = x.shape[0]
    use_peepholes = bool(op_.attr("use_peepholes", False))
    gate = _ACTS[op_.attr("gate_activation", "sigmoid")]
    cell = _ACTS[op_.attr("cell_activation", "tanh")]
    cand = _ACTS[op_.attr("candidate_activation", "tanh")]
    proj = _ACTS[op_.attr("proj_activation", "tanh")]
    is_reverse = bool(op_.attr("is_reverse", False))
    if use_peepholes and (bias is None or bias.shape[0] < 7 * h_dim):
        raise ValueError("use_peepholes=True requires a Bias of width 7*H")
    lengths, mask = _step_mask(ctx, op_, x)
    xs, mask = _time_major(x, mask, is_reverse)
    if bias is not None:
        xs = xs + bias[: 4 * h_dim]
    r, c = x.new_zeros((bsz, p_dim)), x.new_zeros((bsz, h_dim))
    rs, cs = [], []
    for t in range(xs.shape[0]):
        g = torch.addmm(xs[t], r, w)
        gi, gf, gc, go = g.split(h_dim, dim=1)
        if use_peepholes:
            gi = gi + c * bias[4 * h_dim: 5 * h_dim]
            gf = gf + c * bias[5 * h_dim: 6 * h_dim]
        c_new = gate(gf) * c + gate(gi) * cand(gc)
        if use_peepholes:
            go = go + c_new * bias[6 * h_dim: 7 * h_dim]
        r_new = proj(torch.mm(gate(go) * cell(c_new), pw))
        m = None if mask is None else mask[t]
        rs.append(_emit(m, r_new))
        cs.append(_emit(m, c_new))
        r, c = _keep(m, r_new, r), _keep(m, c_new, c)
    _set_lengths(ctx, op_, ("Projection", "Cell"), lengths)
    return {"Projection": [_batch_major(torch.stack(rs), is_reverse)],
            "Cell": [_batch_major(torch.stack(cs), is_reverse)]}


def _gru_infer(op_, block):
    xv = in_var(op_, block, "Input")
    if xv is None or xv.shape is None:
        return
    b, t, h3 = xv.shape[0], xv.shape[1], xv.shape[2]
    h = h3 // 3 if h3 and h3 > 0 else None
    set_out(op_, block, "Hidden", [b, t, h], xv.dtype)


@op("gru", infer_shape=_gru_infer)
def _gru(ctx, op_, ins):
    """Fused GRU over a padded sequence (reference gru_op.cc; JAX
    sequence_ops.py:228). Input [B, T, 3H] pre-projected; Weight [H, 3H]:
    the first [H, 2H] update|reset, the last [H, H] candidate;
    h = u * h_prev + (1 - u) * c."""
    x, w = ins["Input"][0], ins["Weight"][0]
    h_dim = w.shape[0]
    bias = _opt(ins, "Bias")
    bias = x.new_zeros(3 * h_dim) if bias is None else bias.reshape(-1)
    is_reverse = bool(op_.attr("is_reverse", False))
    gate = _ACTS[op_.attr("gate_activation", "sigmoid")]
    cand = _ACTS[op_.attr("activation", "tanh")]
    w_ur, w_c = w[:, : 2 * h_dim], w[:, 2 * h_dim:]
    h0 = _opt(ins, "H0")
    h = h0 if h0 is not None else x.new_zeros((x.shape[0], h_dim))
    lengths, mask = _step_mask(ctx, op_, x)
    xs, mask = _time_major(x, mask, is_reverse)
    hs = []
    for t in range(xs.shape[0]):
        xt = xs[t]
        ur = gate(torch.addmm(xt[:, : 2 * h_dim] + bias[: 2 * h_dim],
                              h, w_ur))
        u, r = ur.split(h_dim, dim=1)
        c = cand(torch.addmm(xt[:, 2 * h_dim:] + bias[2 * h_dim:],
                             r * h, w_c))
        h_new = u * h + (1.0 - u) * c
        m = None if mask is None else mask[t]
        hs.append(_emit(m, h_new))
        h = _keep(m, h_new, h)
    _set_lengths(ctx, op_, ("Hidden",), lengths)
    return {"Hidden": [_batch_major(torch.stack(hs), is_reverse)]}


def _lstm_unit_infer(op_, block):
    cv = in_var(op_, block, "C_prev")
    if cv is not None and cv.shape is not None:
        set_out(op_, block, "C", cv.shape, cv.dtype)
        set_out(op_, block, "H", cv.shape, cv.dtype)


@op("lstm_unit", infer_shape=_lstm_unit_infer)
def _lstm_unit(ctx, op_, ins):
    """One LSTM step (reference lstm_unit_op.cc): X = [B, 4H] gates (x W_x
    + h W_h + b), C_prev [B, H]; outputs C, H."""
    gates, c_prev = ins["X"][0], ins["C_prev"][0]
    forget_bias = float(op_.attr("forget_bias", 0.0))
    gi, gf, gc, go = gates.chunk(4, dim=-1)
    c = torch.sigmoid(gf + forget_bias) * c_prev + \
        torch.sigmoid(gi) * torch.tanh(gc)
    h = torch.sigmoid(go) * torch.tanh(c)
    return {"C": [c], "H": [h]}


def _gru_unit_infer(op_, block):
    hv = in_var(op_, block, "HiddenPrev")
    iv = in_var(op_, block, "Input")
    if hv is not None and hv.shape is not None:
        set_out(op_, block, "Hidden", hv.shape, hv.dtype)
        set_out(op_, block, "ResetHiddenPrev", hv.shape, hv.dtype)
    if iv is not None and iv.shape is not None:
        set_out(op_, block, "Gate", iv.shape, iv.dtype)


@op("gru_unit", infer_shape=_gru_unit_infer)
def _gru_unit(ctx, op_, ins):
    """One GRU step (reference gru_unit_op.cc): Input [B, 3H] x projection,
    HiddenPrev [B, H], Weight [H, 3H], Bias [1, 3H]."""
    x, h_prev, w = ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0]
    h_dim = h_prev.shape[-1]
    bias = _opt(ins, "Bias")
    bias = x.new_zeros(3 * h_dim) if bias is None else bias.reshape(-1)
    gate = _ACTS[op_.attr("gate_activation", "sigmoid")]
    cand = _ACTS[op_.attr("activation", "tanh")]
    ur = gate(x[:, : 2 * h_dim] + h_prev @ w[:, : 2 * h_dim]
              + bias[: 2 * h_dim])
    u, r = ur.split(h_dim, dim=-1)
    c = cand(x[:, 2 * h_dim:] + (r * h_prev) @ w[:, 2 * h_dim:]
             + bias[2 * h_dim:])
    h = u * h_prev + (1.0 - u) * c
    return {"Hidden": [h], "Gate": [torch.cat([u, r, c], -1)],
            "ResetHiddenPrev": [r * h_prev]}


# ---------------------------------------------------------------------------
# Sequence reductions and transforms
# ---------------------------------------------------------------------------

def _bcast(mask, x):
    """[B, T] mask shaped to broadcast over x [B, T, ...]."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))


def _seq_pool_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is None or xv.shape is None:
        return
    set_out(op_, block, "Out", [xv.shape[0]] + list(xv.shape[2:]), xv.dtype)


@op("sequence_pool", infer_shape=_seq_pool_infer)
def _sequence_pool(ctx, op_, ins):
    """Pool over the time axis by length mask (reference
    sequence_pool_op.cc; JAX sequence_ops.py:339): SUM, AVERAGE, SQRT,
    MAX, LAST, FIRST; [B, T, D] -> [B, D]."""
    x = ins["X"][0]
    pooltype = str(op_.attr("pooltype", "AVERAGE")).upper()
    lengths = _lengths(ctx, op_, "X")
    bsz, t = x.shape[0], x.shape[1]
    mask = torch.ones((bsz, t), dtype=x.dtype, device=x.device) \
        if lengths is None else time_mask(lengths, t, x.dtype)
    m = _bcast(mask, x)
    n = torch.clamp(mask.sum(dim=1), min=1.0).reshape(
        (bsz,) + (1,) * (x.dim() - 2))
    if pooltype == "SUM":
        out = (x * m).sum(dim=1)
    elif pooltype == "AVERAGE":
        out = (x * m).sum(dim=1) / n
    elif pooltype == "SQRT":
        out = (x * m).sum(dim=1) / torch.sqrt(n)
    elif pooltype == "MAX":
        neg = torch.finfo(x.dtype).min
        out = torch.where(m > 0, x, torch.full_like(x, neg)).amax(dim=1)
    elif pooltype == "LAST":
        if lengths is None:
            out = x[:, t - 1]
        else:
            # an empty sequence reads the last padded step, as JAX's
            # take_along_axis reads index -1
            idx = (lengths.long() - 1) % t
            idx = idx.reshape((bsz, 1) + (1,) * (x.dim() - 2)).expand(
                (bsz, 1) + tuple(x.shape[2:]))
            out = torch.gather(x, 1, idx).squeeze(1)
    elif pooltype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {pooltype}")
    _set_lengths(ctx, op_, ("Out",), None)
    return {"Out": [out]}


@op("sequence_softmax")
def _sequence_softmax(ctx, op_, ins):
    """Softmax over each sequence's steps (reference
    sequence_softmax_op.cc); x [B, T] or [B, T, 1]; padded steps 0."""
    x = ins["X"][0]
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    v = x.reshape(x.shape[:2]) if squeeze else x
    lengths = _lengths(ctx, op_, "X")
    if lengths is None:
        out = torch.softmax(v, dim=1)
    else:
        keep = time_mask(lengths, v.shape[1], torch.bool)
        logits = torch.where(keep, v, torch.full_like(v, torch.finfo(v.dtype).min))
        out = torch.where(keep, torch.softmax(logits, dim=1),
                          torch.zeros_like(v))
    if squeeze:
        out = out[..., None]
    return {"Out": [out]}


def _seq_expand_infer(op_, block):
    xv, yv = in_var(op_, block, "X"), in_var(op_, block, "Y")
    if xv is None or yv is None or xv.shape is None or yv.shape is None:
        return
    feat = list(xv.shape[1:]) if len(xv.shape) == 2 else list(xv.shape[2:])
    set_out(op_, block, "Out",
            [xv.shape[0], yv.shape[1] if len(yv.shape) > 1 else None]
            + feat, xv.dtype)


@op("sequence_expand", infer_shape=_seq_expand_infer, non_diff_inputs=("Y",))
def _sequence_expand(ctx, op_, ins):
    """Broadcast each batch row of X across Y's steps (reference
    sequence_expand_op.cc; JAX sequence_ops.py:404): X [B, D] (or [B, 1,
    D]) -> [B, Ty, D], masked to Y's lengths."""
    x, y = ins["X"][0], ins["Y"][0]
    ylen = _lengths(ctx, op_, "Y")
    t = y.shape[1]
    if x.dim() == 2:
        out = x[:, None, :].expand(x.shape[0], t, x.shape[1])
    else:
        if x.shape[1] != 1:
            raise ValueError("padded sequence_expand supports one row per "
                             "sequence in X")
        out = x.expand((x.shape[0], t) + tuple(x.shape[2:]))
    mask = torch.ones((x.shape[0], t), dtype=x.dtype, device=x.device) \
        if ylen is None else time_mask(ylen, t, x.dtype)
    out = out * _bcast(mask, out)
    _set_lengths(ctx, op_, ("Out",), ylen)
    return {"Out": [out]}


def _seq_conv_infer(op_, block):
    xv = in_var(op_, block, "X")
    fv = in_var(op_, block, "Filter")
    if xv is None or xv.shape is None or fv is None or fv.shape is None:
        return
    set_out(op_, block, "Out", list(xv.shape[:2]) + [fv.shape[1]], xv.dtype)


def _shift(x, shift):
    """x [B, T, D] moved `shift` steps back in time (row t reads t+shift),
    zeros past either end."""
    t = x.shape[1]
    if shift == 0:
        return x
    out = torch.zeros_like(x)
    if abs(shift) >= t:
        return out
    if shift < 0:
        out[:, -shift:] = x[:, : t + shift]
    else:
        out[:, : t - shift] = x[:, shift:]
    return out


def _window(x, start, length):
    """[B, T, length*D]: for each step the rows [t+start, t+start+length)
    side by side, zero outside the sequence."""
    return torch.cat([_shift(x, start + j) for j in range(length)], dim=-1)


@op("sequence_conv", infer_shape=_seq_conv_infer)
def _sequence_conv(ctx, op_, ins):
    """Context-window convolution over time (reference sequence_conv_op.cc,
    math/context_project.h; JAX sequence_ops.py:435): each step's window
    of contextLength rows from contextStart (zero outside the sequence),
    projected by Filter [k*D, M]: k shifted copies and one GEMM."""
    x, filt = ins["X"][0], ins["Filter"][0]
    k = int(op_.attr("contextLength", 3))
    start = int(op_.attr("contextStart", -((k - 1) // 2)))
    lengths = _lengths(ctx, op_, "X")
    bsz, t, _d = x.shape
    mask = None if lengths is None else time_mask(lengths, t, x.dtype)[..., None]
    xm = x if mask is None else x * mask
    out = torch.matmul(_window(xm, start, k), filt)
    if mask is not None:
        out = out * mask
    return {"Out": [out]}


@op("sequence_concat")
def _sequence_concat(ctx, op_, ins):
    """Concatenate the inputs' sequences instance by instance along time
    (reference sequence_concat_op.cc; JAX sequence_ops.py:464): each input
    shifted to start at the running length and summed, its padding zeroed
    first."""
    xs = list(ins["X"])
    lens = [ctx.seq_len(n) for n in op_.desc.inputs["X"]]
    bsz = xs[0].shape[0]
    total_t = sum(v.shape[1] for v in xs)
    xs = [v if ln is None else v * _bcast(time_mask(ln, v.shape[1], v.dtype), v)
          for v, ln in zip(xs, lens)]
    full = [torch.nn.functional.pad(
        v, (0, 0) * (v.dim() - 2) + (0, total_t - v.shape[1])) for v in xs]
    out = full[0]
    offset = lens[0].to(torch.int32) if lens[0] is not None else torch.full(
        (bsz,), xs[0].shape[1], dtype=torch.int32, device=out.device)
    steps = torch.arange(total_t, device=out.device)
    for v, ln, orig in zip(full[1:], lens[1:], xs[1:]):
        idx = steps[None, :] - offset[:, None]
        valid = idx >= 0
        idx = idx.clamp(0, total_t - 1)
        shape = (bsz, total_t) + (1,) * (v.dim() - 2)
        gathered = torch.gather(v, 1, idx.reshape(shape).expand(v.shape))
        out = out + torch.where(valid.reshape(shape), gathered,
                                torch.zeros_like(gathered))
        li = ln.to(torch.int32) if ln is not None else torch.full(
            (bsz,), orig.shape[1], dtype=torch.int32, device=out.device)
        offset = offset + li
    _set_lengths(ctx, op_, ("Out",), offset)
    return {"Out": [out]}


@op("sequence_reshape")
def _sequence_reshape(ctx, op_, ins):
    """Change the feature width, the lengths scaled (reference
    sequence_reshape_op.cc): [B, T, D] -> [B, T*D/new_dim, new_dim]."""
    x = ins["X"][0]
    new_dim = int(op_.attr("new_dim"))
    bsz, t, d = x.shape
    if (t * d) % new_dim:
        raise ValueError(f"sequence_reshape: T*D={t * d} is not a multiple "
                         f"of new_dim {new_dim}")
    out = x.reshape(bsz, t * d // new_dim, new_dim)
    lengths = _lengths(ctx, op_, "X")
    _set_lengths(ctx, op_, ("Out",), None if lengths is None
                 else torch.div(lengths * d, new_dim, rounding_mode="floor")
                 .to(lengths.dtype))
    return {"Out": [out]}


@op("sequence_slice", non_diff_inputs=("Offset", "Length"))
def _sequence_slice(ctx, op_, ins):
    """Per-sequence slice (reference sequence_slice_op.cc; JAX
    sequence_ops.py:520): [offset_i, offset_i + length_i) of each
    sequence, the length clamped to what the sequence holds."""
    x = ins["X"][0]
    offset = ins["Offset"][0].reshape(-1).to(torch.int32)
    length = ins["Length"][0].reshape(-1).to(torch.int32)
    bsz, t = x.shape[0], x.shape[1]
    in_len = ctx.seq_len(op_.desc.inputs["X"][0])
    avail = in_len.to(torch.int32) if in_len is not None else torch.full(
        (bsz,), t, dtype=torch.int32, device=x.device)
    eff_len = torch.clamp(torch.minimum(length, avail - offset), 0, t)
    steps = torch.arange(t, device=x.device)
    idx = (steps[None, :] + offset[:, None]).clamp(0, t - 1).long()
    shape = (bsz, t) + (1,) * (x.dim() - 2)
    out = torch.gather(x, 1, idx.reshape(shape).expand(x.shape))
    keep = (steps[None, :] < eff_len[:, None]).reshape(shape)
    out = torch.where(keep, out, torch.zeros_like(out))
    _set_lengths(ctx, op_, ("Out",), eff_len)
    return {"Out": [out]}


@op("sequence_erase", grad=NO_GRAD)
def _sequence_erase(ctx, op_, ins):
    """Remove the `tokens` from each int sequence (reference
    sequence_erase_op.cc; JAX sequence_ops.py:546): the kept tokens move
    to the front by a stable sort on the removal flags; the shape stays."""
    x = ins["X"][0]
    tokens = list(op_.attr("tokens", []) or [])
    v = x.reshape(x.shape[0], x.shape[1])
    lengths = _lengths(ctx, op_, "X")
    bsz, t = v.shape
    inlen = torch.ones((bsz, t), dtype=torch.bool, device=x.device) \
        if lengths is None else time_mask(lengths, t, torch.bool)
    erase = ~inlen
    for tok in tokens:
        erase = erase | (v == tok)
    _, order = torch.sort(erase.to(torch.int32), dim=1, stable=True)
    out = torch.gather(v, 1, order)
    new_len = (~erase).sum(dim=1).to(torch.int32)
    keep = torch.arange(t, device=x.device)[None, :] < new_len[:, None]
    out = torch.where(keep, out, torch.zeros_like(out))
    if x.dim() == 3:
        out = out[..., None]
    _set_lengths(ctx, op_, ("Out",), new_len)
    return {"Out": [out]}


@op("lod_reset", non_diff_inputs=("Y",))
def _lod_reset(ctx, op_, ins):
    """Re-partition a sequence batch under a new LoD (reference
    lod_reset_op.cc; JAX sequence_ops.py:571). With the attr target_lod
    the valid rows compact to the front (a stable sort on the padding
    mask) and split again by the new offsets, a static shape; with a Y
    offsets input only the lengths change."""
    x = ins["X"][0]
    y = _opt(ins, "Y")
    if y is not None:
        y = y.reshape(-1).to(torch.int32)
        _set_lengths(ctx, op_, ("Out",), y[1:] - y[:-1])
        return {"Out": [x]}
    offs = np.asarray(op_.attr("target_lod", []), dtype=np.int32)
    new_lens = offs[1:] - offs[:-1]
    old = ctx.seq_len(op_.desc.inputs["X"][0])
    if x.dim() >= 2 and old is not None:
        b, t = x.shape[0], x.shape[1]
        flat_valid = time_mask(old, t, torch.bool).reshape(-1)
        _, order = torch.sort((~flat_valid).to(torch.int32), stable=True)
        flat_rows = x.reshape((b * t,) + tuple(x.shape[2:]))[order]
        b2 = len(new_lens)
        t2 = int(new_lens.max()) if len(new_lens) else 1
        idx = np.zeros((b2, t2), dtype=np.int64)
        for i in range(b2):
            for j in range(t2):
                idx[i, j] = offs[i] + min(j, max(int(new_lens[i]) - 1, 0))
        out = flat_rows[ctx.executor.constant(idx.reshape(-1), torch.int64)]
        out = out.reshape((b2, t2) + tuple(x.shape[2:]))
        mask = (np.arange(t2)[None, :] < new_lens[:, None]).reshape(
            (b2, t2) + (1,) * (x.dim() - 2))
        out = out * ctx.executor.constant(mask, x.dtype)
    else:
        out = x
    _set_lengths(ctx, op_, ("Out",),
                 ctx.executor.constant(new_lens, torch.int32))
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# Nested (level-2) LoD
# ---------------------------------------------------------------------------

def _unfold_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is not None and xv.shape is not None and len(xv.shape) >= 2:
        b, sdim = xv.shape[0], xv.shape[1]
        lead = None if (b is None or b < 0 or sdim is None or sdim < 0) \
            else b * sdim
        set_out(op_, block, "Out", [lead if lead is not None else -1]
                + list(xv.shape[2:]), xv.dtype)


@op("sequence_unfold", infer_shape=_unfold_infer)
def _sequence_unfold(ctx, op_, ins):
    """A nested batch [B, S, T, ...] -> its sub-sequences [B*S, T, ...],
    whose lengths are the flattened inner lengths (0 for padded
    sub-slots) (JAX sequence_ops.py:630); sequence_fold restores the outer
    grouping."""
    x = ins["X"][0]
    b, s = x.shape[0], x.shape[1]
    name = op_.desc.inputs["X"][0]
    inner = ctx.seq_len2(name)
    outer = ctx.seq_len(name)
    if inner is None:
        inner = torch.full((b, s), x.shape[2], dtype=torch.int32,
                           device=x.device)
        if outer is not None:
            inner = torch.where(time_mask(outer, s, torch.bool), inner,
                                torch.zeros_like(inner))
    out = x.reshape((b * s,) + tuple(x.shape[2:]))
    out_name = op_.desc.outputs["Out"][0]
    ctx.set_seq_len(out_name, inner.reshape(-1))
    ctx.set_seq_len2(out_name, None)
    return {"Out": [out]}


def _fold_infer(op_, block):
    xv = in_var(op_, block, "X")
    lv = in_var(op_, block, "OuterLike")
    if xv is not None and xv.shape is not None and lv is not None \
            and lv.shape is not None and len(lv.shape) >= 2:
        set_out(op_, block, "Out",
                [lv.shape[0], lv.shape[1]] + list(xv.shape[1:]), xv.dtype)


@op("sequence_fold", non_diff_inputs=("OuterLike",), infer_shape=_fold_infer)
def _sequence_fold(ctx, op_, ins):
    """The inverse of sequence_unfold: [B*S, ...] -> [B, S, ...], the outer
    lengths from OuterLike (the nested var sequence_unfold read)."""
    x = ins["X"][0]
    like_name = op_.desc.inputs["OuterLike"][0]
    like = ins["OuterLike"][0]
    b, s = like.shape[0], like.shape[1]
    out = x.reshape((b, s) + tuple(x.shape[1:]))
    out_name = op_.desc.outputs["Out"][0]
    ctx.set_seq_len(out_name, ctx.seq_len(like_name))
    inner = None
    # the inner lengths survive only if the payload still has a time axis
    if out.dim() >= 3 and ctx.seq_len2(like_name) is not None \
            and out.shape[2] == like.shape[2]:
        inner = ctx.seq_len2(like_name)
    ctx.set_seq_len2(out_name, inner)
    return {"Out": [out]}


def _context_project_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is not None and xv.shape is not None:
        shape = list(xv.shape)
        shape[-1] = shape[-1] * op_.attr("context_length", 1)
        set_out(op_, block, "Out", shape, xv.dtype)


@op("context_project", infer_shape=_context_project_infer)
def _context_project(ctx, op_, ins):
    """A window of neighbouring steps side by side on the feature axis
    (reference gserver ContextProjection; JAX sequence_ops.py:695):
    out[:, t] = [x[:, t+s], ..., x[:, t+s+L-1]], zero outside each
    sequence."""
    x = ins["X"][0]
    start = op_.attr("context_start", 0)
    length = op_.attr("context_length", 1)
    b, t, _d = x.shape
    lengths = _lengths(ctx, op_, "X")
    if lengths is not None:
        x = x * time_mask(lengths, t, x.dtype)[..., None]
    return {"Out": [_window(x, start, length)]}


@op("sequence_mask", grad=NO_GRAD)
def _sequence_mask(ctx, op_, ins):
    """[B, T] float mask of the valid steps of a padded sequence var, from
    its lengths (JAX sequence_ops.py:732); all ones for a dense var."""
    x = ins["X"][0]
    lengths = ctx.seq_len(op_.desc.inputs["X"][0])
    if lengths is None:
        mask = torch.ones(tuple(x.shape[:2]), dtype=torch.float32,
                          device=x.device)
    else:
        mask = time_mask(lengths, x.shape[1])
    return {"Y": [mask]}
