"""Vision op family: 3-D pooling and transposed conv, pooling with index,
unpool, spatial pyramid pooling, ROI pooling, crop, prelu, conv_shift,
bilinear_interp (the port's counterpart of paddle_tpu/ops/vision_ops.py;
reference pool_op.cc [pool3d], pool_with_index_op.cc, unpool_op.cc,
spp_op.cc, roi_pool_op.cc, crop_op.cc, conv_transpose_op.cc
[conv3d_transpose], prelu_op.cc, conv_shift_op.cc, gserver
BilinearInterpLayer.cpp).

Every lowering is dense torch with shapes fixed by the attrs and the input
shapes: windows are strided slices of a padded input, ROI bins are
membership masks over the feature plane, and a crop at offsets given as a
tensor is a gather, so nothing reads a device value on the host and a
step holding one of these ops can be captured as a CUDA graph. Their
grads are the generic grad (autograd over the lowering), as the JAX
package takes the vjp of its: a max routes its cotangent to the argmax,
as the reference's saved masks do. The index outputs are int32.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from .common import in_var, mxu_cast, same_as_input, set_out
from .registry import op

_NEG_INF = float("-inf")


def _triple(v):
    if isinstance(v, (list, tuple)):
        return list(v) if len(v) == 3 else list(v) * 3
    return [v, v, v]


def _pair(v):
    if isinstance(v, (list, tuple)):
        return list(v) if len(v) == 2 else list(v) * 2
    return [v, v]


def _pad_spatial(x, pads, value):
    """`pads` (before, after) per spatial dim, first dim first."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


# --- pool3d -----------------------------------------------------------------

def _pool3d_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is None or xv.shape is None:
        return
    if op_.attr("global_pooling", False):
        set_out(op_, block, "Out", list(xv.shape[:2]) + [1, 1, 1], xv.dtype)
        return
    k = _triple(op_.attr("ksize"))
    s = _triple(op_.attr("strides", [1, 1, 1]))
    p = _triple(op_.attr("paddings", [0, 0, 0]))

    def odim(i, kk, pp, ss):
        if i is None or i < 0:
            return None
        if op_.attr("ceil_mode", False):
            return (i - kk + 2 * pp + ss - 1) // ss + 1
        return (i - kk + 2 * pp) // ss + 1

    n, c, d, h, w = xv.shape
    set_out(op_, block, "Out",
            [n, c, odim(d, k[0], p[0], s[0]), odim(h, k[1], p[1], s[1]),
             odim(w, k[2], p[2], s[2])], xv.dtype)


@op("pool3d", infer_shape=_pool3d_infer)
def _pool3d(ctx, op_, ins):
    """NCDHW max / avg pooling, floor mode (as the JAX lowering). The input
    is padded here (-inf for max, 0 for avg), so any padding works; avg is
    exclusive by default (divides by the valid cells)."""
    x = ins["X"][0]
    if op_.attr("global_pooling", False):
        k = list(x.shape[2:])
        s, p = k, [0, 0, 0]
    else:
        k = _triple(op_.attr("ksize"))
        s = _triple(op_.attr("strides", [1, 1, 1]))
        p = _triple(op_.attr("paddings", [0, 0, 0]))
    pads = [(pi, pi) for pi in p]
    if op_.attr("pooling_type", "max") == "max":
        out = F.max_pool3d(_pad_spatial(x, pads, _NEG_INF), k, s)
        return {"Out": [out]}
    vol = k[0] * k[1] * k[2]
    total = F.avg_pool3d(_pad_spatial(x, pads, 0.0), k, s) * vol
    if op_.attr("exclusive", True):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        cnt = F.avg_pool3d(_pad_spatial(ones, pads, 0.0), k, s) * vol
        return {"Out": [total / cnt]}
    return {"Out": [total / vol]}


# --- max pool with index ----------------------------------------------------

def _windows(x, k, s, p):
    """x (N, C, *S) -> its windows (N, C, *O, prod k), padded with -inf,
    and the flat input index of each window cell ((*O, prod k), -1 in the
    padding), cells in row-major window order."""
    nd = len(k)
    sp = list(x.shape[2:])
    o = [(sp[i] - k[i] + 2 * p[i]) // s[i] + 1 for i in range(nd)]
    xp = _pad_spatial(x, [(pi, pi) for pi in p], _NEG_INF)
    cols, idxs = [], []
    grids = torch.meshgrid(*[torch.arange(o[i], device=x.device) * s[i]
                             for i in range(nd)], indexing="ij")
    for ks in itertools.product(*[range(ki) for ki in k]):
        sl = tuple(slice(ks[i], ks[i] + (o[i] - 1) * s[i] + 1, s[i])
                   for i in range(nd))
        cols.append(xp[(slice(None), slice(None)) + sl])
        valid = torch.ones(o, dtype=torch.bool, device=x.device)
        flat = torch.zeros(o, dtype=torch.int64, device=x.device)
        for i in range(nd):
            pos = grids[i] + ks[i] - p[i]
            valid &= (pos >= 0) & (pos < sp[i])
            flat = flat * sp[i] + pos
        idxs.append(torch.where(valid, flat, torch.full_like(flat, -1)))
    return torch.stack(cols, dim=-1), torch.stack(idxs, dim=-1)


def _pool_index_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is None or xv.shape is None:
        return
    nd = len(xv.shape) - 2
    if op_.attr("global_pooling", False):
        oshape = list(xv.shape[:2]) + [1] * nd
    else:
        k = op_.attr("ksize")
        s = op_.attr("strides", [1] * nd)
        p = op_.attr("paddings", [0] * nd)
        oshape = list(xv.shape[:2]) + [
            None if d is None else (d - k[i] + 2 * p[i]) // s[i] + 1
            for i, d in enumerate(xv.shape[2:])]
    set_out(op_, block, "Out", oshape, xv.dtype)
    set_out(op_, block, "Mask", oshape, "int32")


def _max_pool_with_index(op_, x, nd):
    """(Out, Mask): the max of each window and the flat index of its first
    maximum (row-major window order, jnp.argmax's tie rule) into the
    input's spatial plane."""
    expand = _pair if nd == 2 else _triple
    if op_.attr("global_pooling", False):
        k, s, p = list(x.shape[2:]), list(x.shape[2:]), [0] * nd
    else:
        k = expand(op_.attr("ksize"))
        s = expand(op_.attr("strides", [1] * nd))
        p = expand(op_.attr("paddings", [0] * nd))
    wins, idx = _windows(x, k, s, p)
    am = torch.argmax(wins, dim=-1, keepdim=True)
    out = torch.take_along_dim(wins, am, dim=-1)[..., 0]
    mask = torch.take_along_dim(idx.expand(wins.shape), am, dim=-1)[..., 0]
    return {"Out": [out], "Mask": [mask.to(torch.int32)]}


@op("max_pool2d_with_index", infer_shape=_pool_index_infer)
def _max_pool2d_with_index(ctx, op_, ins):
    return _max_pool_with_index(op_, ins["X"][0], 2)


@op("max_pool3d_with_index", infer_shape=_pool_index_infer)
def _max_pool3d_with_index(ctx, op_, ins):
    return _max_pool_with_index(op_, ins["X"][0], 3)


# --- unpool -----------------------------------------------------------------

def _unpool_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is None or xv.shape is None:
        return
    us = op_.attr("unpooled_size", None)
    if us:
        set_out(op_, block, "Out", list(xv.shape[:2]) + list(us), xv.dtype)


@op("unpool", infer_shape=_unpool_infer, non_diff_inputs=("Indices",))
def _unpool(ctx, op_, ins):
    """Max-unpool: each pooled value written back at its Indices (as
    max_pool2d_with_index makes them), zeros elsewhere."""
    x = ins["X"][0]
    idx = ins["Indices"][0].to(torch.int64)
    oh, ow = op_.attr("unpooled_size")
    n, c = x.shape[:2]
    out = torch.zeros((n * c, oh * ow), dtype=x.dtype, device=x.device)
    out = out.scatter(1, idx.reshape(n * c, -1), x.reshape(n * c, -1))
    return {"Out": [out.reshape(n, c, oh, ow)]}


# --- spatial pyramid pooling ------------------------------------------------

def _spp_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is None or xv.shape is None:
        return
    bins = sum(4 ** i for i in range(op_.attr("pyramid_height")))
    n, c = xv.shape[:2]
    set_out(op_, block, "Out", [n, None if c is None else c * bins],
            xv.dtype)


@op("spp", infer_shape=_spp_infer)
def _spp(ctx, op_, ins):
    """Pooling at 1x1, 2x2, 4x4... grids, each level's bins of ceil(H/b) x
    ceil(W/b) cells padded about evenly, the levels flattened and
    concatenated; avg divides by the whole bin, padding included."""
    x = ins["X"][0]
    is_max = op_.attr("pooling_type", "max") == "max"
    n, c, h, w = x.shape
    outs = []
    for level in range(op_.attr("pyramid_height")):
        b = 2 ** level
        kh, kw = math.ceil(h / b), math.ceil(w / b)
        ph = (kh * b - h + 1) // 2
        pw = (kw * b - w + 1) // 2
        pads = [(ph, kh * b - h - ph), (pw, kw * b - w - pw)]
        if is_max:
            o = F.max_pool2d(_pad_spatial(x, pads, _NEG_INF), (kh, kw))
        else:
            o = F.avg_pool2d(_pad_spatial(x, pads, 0.0), (kh, kw))
        outs.append(o.reshape(n, -1))
    return {"Out": [torch.cat(outs, dim=1)]}


# --- ROI pooling ------------------------------------------------------------

def _roi_pool_infer(op_, block):
    xv = in_var(op_, block, "X")
    rv = in_var(op_, block, "ROIs")
    if xv is None or xv.shape is None or rv is None or rv.shape is None:
        return
    ph, pw = op_.attr("pooled_height"), op_.attr("pooled_width")
    set_out(op_, block, "Out", [rv.shape[0], xv.shape[1], ph, pw], xv.dtype)
    set_out(op_, block, "Argmax", [rv.shape[0], xv.shape[1], ph, pw], "int32")


@op("roi_pool", infer_shape=_roi_pool_infer,
    non_diff_inputs=("ROIs", "RoiBatchId"))
def _roi_pool(ctx, op_, ins):
    """ROI max pooling. ROIs are [x1, y1, x2, y2] rows scaled by
    `spatial_scale` and rounded (half to even, as jnp.round); each ROI's
    pooled_h x pooled_w bins (floor starts, ceil ends, clipped to the
    plane) are membership masks over the feature plane, and a bin's max
    is the masked max at its first argmax (Argmax, the flat h*W+w index);
    an empty bin gives 0. The owning image of each ROI comes from the
    optional RoiBatchId input (0 without it)."""
    x = ins["X"][0]                      # (N, C, H, W)
    rois = ins["ROIs"][0]                # (R, 4)
    scale = op_.attr("spatial_scale", 1.0)
    ph, pw = op_.attr("pooled_height"), op_.attr("pooled_width")
    n, c, h, w = x.shape
    r = rois.shape[0]
    dev = x.device
    if ins.get("RoiBatchId") and ins["RoiBatchId"][0] is not None:
        bid = ins["RoiBatchId"][0].reshape(-1).to(torch.int64)
    else:
        bid = torch.zeros((r,), dtype=torch.int64, device=dev)
    corners = torch.round(rois * scale).to(torch.int64)
    x1, y1, x2, y2 = corners.unbind(dim=1)
    rh = torch.clamp(y2 - y1 + 1, min=1)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    pi = torch.arange(ph, device=dev)
    pj = torch.arange(pw, device=dev)

    def fdiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    hstart = (y1[:, None] + fdiv(pi[None, :] * rh[:, None], ph)).clamp(0, h)
    hend = (y1[:, None] + fdiv((pi[None, :] + 1) * rh[:, None] + ph - 1,
                               ph)).clamp(0, h)
    wstart = (x1[:, None] + fdiv(pj[None, :] * rw[:, None], pw)).clamp(0, w)
    wend = (x1[:, None] + fdiv((pj[None, :] + 1) * rw[:, None] + pw - 1,
                               pw)).clamp(0, w)
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    rmask = (rows[None, None, :] >= hstart[:, :, None]) & \
        (rows[None, None, :] < hend[:, :, None])          # (R, ph, H)
    cmask = (cols[None, None, :] >= wstart[:, :, None]) & \
        (cols[None, None, :] < wend[:, :, None])          # (R, pw, W)
    mask = rmask[:, :, None, :, None] & cmask[:, None, :, None, :]
    feat = x[bid]                                          # (R, C, H, W)
    masked = torch.where(mask[:, None], feat[:, :, None, None],
                         torch.full((), _NEG_INF, dtype=x.dtype, device=dev))
    flat = masked.reshape(r, c, ph, pw, h * w)
    am = torch.argmax(flat, dim=-1, keepdim=True)
    out = torch.take_along_dim(flat, am, dim=-1)[..., 0]
    empty = ~torch.any(mask.reshape(r, ph, pw, h * w), dim=-1)
    out = torch.where(empty[:, None], torch.zeros_like(out), out)
    return {"Out": [out], "Argmax": [am[..., 0].to(torch.int32)]}


# --- crop -------------------------------------------------------------------

def _crop_infer(op_, block):
    xv = in_var(op_, block, "X")
    shp = op_.attr("shape", None)
    yv = in_var(op_, block, "Y")
    if shp:
        set_out(op_, block, "Out", list(shp),
                xv.dtype if xv is not None else None)
    elif yv is not None and yv.shape is not None and xv is not None:
        set_out(op_, block, "Out", yv.shape, xv.dtype)


@op("crop", infer_shape=_crop_infer, non_diff_inputs=("Y", "Offsets"))
def _crop(ctx, op_, ins):
    """X cropped to `shape` (the attr, or Y's shape) at `offsets` (the
    attr, or the Offsets input). Offsets given as a tensor stay on the
    device: each dim's indices are its offset, clipped so the crop fits
    (lax.dynamic_slice's rule), plus an arange, and the crop is a gather."""
    x = ins["X"][0]
    if ins.get("Y") and ins["Y"][0] is not None:
        shape = list(ins["Y"][0].shape)
    else:
        shape = list(op_.attr("shape"))
    if ins.get("Offsets") and ins["Offsets"][0] is not None:
        off = ins["Offsets"][0].reshape(-1).to(torch.int64)
        index = []
        for i in range(x.dim()):
            start = off[i].clamp(0, x.shape[i] - shape[i])
            ix = start + torch.arange(shape[i], device=x.device)
            index.append(ix.reshape((1,) * i + (-1,)
                                    + (1,) * (x.dim() - i - 1)))
        return {"Out": [x[tuple(index)]]}
    off = op_.attr("offsets", [0] * x.dim())
    sl = tuple(slice(o, o + s) for o, s in zip(off, shape))
    return {"Out": [x[sl]]}


# --- conv3d_transpose -------------------------------------------------------

def _convt3d_infer(op_, block):
    xv = in_var(op_, block, "Input")
    wv = in_var(op_, block, "Filter")
    if xv is None or xv.shape is None or wv is None or wv.shape is None:
        return
    s = _triple(op_.attr("strides", [1, 1, 1]))
    p = _triple(op_.attr("paddings", [0, 0, 0]))
    d = _triple(op_.attr("dilations", [1, 1, 1]))
    dims = []
    for i, sz in enumerate(xv.shape[2:]):
        if sz is None or wv.shape[2 + i] is None:
            dims.append(None)
        else:
            k = d[i] * (wv.shape[2 + i] - 1) + 1
            dims.append(s[i] * (sz - 1) + k - 2 * p[i])
    set_out(op_, block, "Output", [xv.shape[0], wv.shape[1]] + dims,
            xv.dtype)


@op("conv3d_transpose", infer_shape=_convt3d_infer)
def _conv3d_transpose(ctx, op_, ins):
    """Transposed 3-D conv, filter IODHW (torch's own layout for it):
    F.conv_transpose3d, as the JAX package lowers it to a plain
    lax.conv_general_dilated (no Pallas kernel). Under AMP the operands go
    through mxu_cast."""
    x, w = ins["Input"][0], ins["Filter"][0]
    s = _triple(op_.attr("strides", [1, 1, 1]))
    p = _triple(op_.attr("paddings", [0, 0, 0]))
    d = _triple(op_.attr("dilations", [1, 1, 1]))
    (x, w), restore = mxu_cast(ctx, x, w)
    out = F.conv_transpose3d(x, w, stride=s, padding=p, dilation=d)
    if restore is not None:
        out = out.to(restore)
    return {"Output": [out]}


# --- prelu ------------------------------------------------------------------

@op("prelu", infer_shape=same_as_input())
def _prelu(ctx, op_, ins):
    """Parametric ReLU: one alpha ("all"), one per channel ("channel", dim
    1), or one per element of a sample ("element", broadcast over the
    batch)."""
    x = ins["X"][0]
    alpha = ins["Alpha"][0]
    mode = op_.attr("mode", "all")
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    else:
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    return {"Out": [torch.where(x > 0, x, a * x)]}


# --- conv_shift -------------------------------------------------------------

def _conv_shift_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is not None:
        set_out(op_, block, "Out", xv.shape, xv.dtype)


@op("conv_shift", infer_shape=_conv_shift_infer)
def _conv_shift(ctx, op_, ins):
    """Circular convolution out[i] = sum_j x[(i + j - N/2) mod M] * y[j]
    (N odd, N <= M): N rolls, N small."""
    x = ins["X"][0]      # (B, M)
    y = ins["Y"][0]      # (B, N)
    n = y.shape[1]
    half = n // 2
    out = torch.zeros_like(x)
    for j in range(n):
        out = out + torch.roll(x, half - j, dims=1) * y[:, j:j + 1]
    return {"Out": [out]}


# --- bilinear_interp --------------------------------------------------------

def _bilinear_infer(op_, block):
    xv = in_var(op_, block, "X")
    if xv is not None and xv.shape is not None:
        set_out(op_, block, "Out",
                [xv.shape[0], xv.shape[1], op_.attr("out_h"),
                 op_.attr("out_w")], xv.dtype)


def _grid(in_size, out_size, device):
    """(fraction, lower index, upper index) of each output row, corners
    aligned (ratio (in-1)/(out-1)); the arithmetic in f32 whatever x's
    dtype, as in the JAX package."""
    if out_size == 1 or in_size == 1:
        z = torch.zeros((out_size,), dtype=torch.int64, device=device)
        return torch.zeros((out_size,), device=device), z, z
    ratio = (in_size - 1.0) / (out_size - 1.0)
    pos = torch.arange(out_size, dtype=torch.float32, device=device) * ratio
    lo = torch.floor(pos).to(torch.int64).clamp(0, in_size - 1)
    hi = torch.clamp(lo + 1, max=in_size - 1)
    return pos - lo.to(torch.float32), lo, hi


@op("bilinear_interp", infer_shape=_bilinear_infer)
def _bilinear_interp(ctx, op_, ins):
    """Bilinear upsampling of NCHW maps, corners aligned: gathers of the
    four neighbours and two lerps."""
    x = ins["X"][0]
    out_h, out_w = int(op_.attr("out_h")), int(op_.attr("out_w"))
    h, w = x.shape[2], x.shape[3]
    fh, h0, h1 = _grid(h, out_h, x.device)
    fw, w0, w1 = _grid(w, out_w, x.device)
    xh0, xh1 = x[:, :, h0], x[:, :, h1]
    tl, tr = xh0[:, :, :, w0], xh0[:, :, :, w1]
    bl, br = xh1[:, :, :, w0], xh1[:, :, :, w1]
    fh = fh[None, None, :, None].to(x.dtype)
    fw = fw[None, None, None, :].to(x.dtype)
    top = tl * (1 - fw) + tr * fw
    bot = bl * (1 - fw) + br * fw
    return {"Out": [top * (1 - fh) + bot * fh]}
