"""Contrib detection ops (counterpart of ``mxnet_tpu/ops/contrib.py``):
ROIAlign, ROIPooling, ``box_iou``, ``box_nms``, bipartite matching, SSD's
``multibox_target`` and ``multibox_detection``, and deformable
convolution.

Every op is plain PyTorch through the funnel, with the JAX package's
static-shape formulation (fixed sample grids, the O(N^2) IoU matrix, the
JAX ``vmap`` over the batch written out as a batch dimension), except the
greedy NMS sweep that ends ``box_nms`` and ``multibox_detection``. The
JAX package runs it as one ``lax.fori_loop`` over every row, n dependent
steps that XLA keeps on the device; in eager PyTorch that loop costs a
few launches a row. On a CUDA tensor :func:`nms_sweep` launches the
hand-written kernel ``csrc/nms_sweep.cu`` (no TPU kernel: it replaces an
XLA loop) over the decision matrix that the plain version's own torch ops
build, so its keep mask is the plain sweep's bit for bit; on a CPU tensor
it runs :func:`nms_sweep_plain`, the loop as the JAX package writes it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..base import MXNetError
from ..ndarray import NDArray, apply, apply_multi

__all__ = ["roi_align", "roi_pooling", "box_iou", "box_nms", "bipartite_matching",
           "multibox_target", "multibox_detection", "deformable_convolution",
           "nms_sweep", "nms_sweep_plain", "nms_decisions"]


def _in(x):
    """An NDArray or a tensor as it is (a tensor call is PyTorch's own),
    host data as an NDArray."""
    return x if isinstance(x, (NDArray, torch.Tensor)) else NDArray(x)


def _bilinear_sample(feat, bidx, ys, xs):
    """``feat`` [B, C, H, W]; ``bidx``, ``ys``, ``xs`` broadcastable index
    grids: bilinear values ``[*grid, C]``. Coordinates in (-1, 0) clamp to
    0, at or past size - 1 to the last cell; fully outside (beyond -1 or
    size) contributes zero (the JAX package's clamping sampler)."""
    H, W = feat.shape[-2], feat.shape[-1]
    valid = (ys > -1.0) & (ys < H) & (xs > -1.0) & (xs < W)
    ys = ys.clamp(0.0, H - 1.0)
    xs = xs.clamp(0.0, W - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    y0i, x0i = y0.long(), x0.long()
    y1i = (y0i + 1).clamp(0, H - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    bidx, y0i, x0i, y1i, x1i = torch.broadcast_tensors(bidx, y0i, x0i, y1i, x1i)
    v00 = feat[bidx, :, y0i, x0i]
    v01 = feat[bidx, :, y0i, x1i]
    v10 = feat[bidx, :, y1i, x0i]
    v11 = feat[bidx, :, y1i, x1i]
    e = (..., None)
    out = (v00 * ((1 - wy1) * (1 - wx1))[e] + v01 * ((1 - wy1) * wx1)[e]
           + v10 * (wy1 * (1 - wx1))[e] + v11 * (wy1 * wx1)[e])
    return torch.where(valid[e], out, torch.zeros((), dtype=out.dtype, device=out.device))


def _bilinear_sample_zeropad(feat, bidx, gidx, ys, xs):
    """``feat`` [B, G, cg, H, W]; index grids ``bidx``, ``gidx``, ``ys``,
    ``xs``: values ``[*grid, cg]`` with zero padding (taps outside the map
    contribute 0 with partial falloff in (-1, 0) and (size - 1, size): the
    JAX package's deformable sampler)."""
    H, W = feat.shape[-2], feat.shape[-1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    y0i, x0i = y0.long(), x0.long()
    out = None
    for dyi, wy in ((0, 1 - wy1), (1, wy1)):
        for dxi, wx in ((0, 1 - wx1), (1, wx1)):
            yi = y0i + dyi
            xi = x0i + dxi
            inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            v = feat[bidx, gidx, :, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
            term = v * (wy * wx * inside)[..., None]
            out = term if out is None else out + term
    return out


def roi_align(data, rois, pooled_size: Tuple[int, int], spatial_scale: float = 1.0,
              sample_ratio: int = 2, position_sensitive: bool = False,
              aligned: bool = False):
    """ROIAlign: ``data`` [B, C, H, W], ``rois`` [N, 5] rows of (batch
    index, x1, y1, x2, y2) in image coordinates; returns [N, C, PH, PW],
    each bin the mean of a fixed ``sample_ratio`` x ``sample_ratio`` grid
    of bilinear samples. ``aligned=True`` shifts by half a pixel."""
    if position_sensitive:
        raise MXNetError("position_sensitive ROIAlign not supported yet")
    ph, pw = pooled_size
    sr = max(int(sample_ratio), 1)
    offset = 0.5 if aligned else 0.0

    def fn(x, r):
        f = r.dtype
        dev = r.device
        bidx = r[:, 0].to(torch.int32).long()
        x1 = r[:, 1] * spatial_scale - offset
        y1 = r[:, 2] * spatial_scale - offset
        x2 = r[:, 3] * spatial_scale - offset
        y2 = r[:, 4] * spatial_scale - offset
        rw = torch.clamp(x2 - x1, min=1.0)
        rh = torch.clamp(y2 - y1, min=1.0)
        bin_h = rh / ph
        bin_w = rw / pw
        iy = (torch.arange(sr, device=dev, dtype=f) + 0.5) / sr
        gy = y1[:, None, None] + (torch.arange(ph, device=dev, dtype=f)[None, :, None]
                                  + iy[None, None, :]) * bin_h[:, None, None]
        gx = x1[:, None, None] + (torch.arange(pw, device=dev, dtype=f)[None, :, None]
                                  + iy[None, None, :]) * bin_w[:, None, None]
        ys = gy[:, :, :, None, None]
        xs = gx[:, None, None, :, :]
        ys, xs = torch.broadcast_tensors(ys, xs)
        vals = _bilinear_sample(x, bidx[:, None, None, None, None], ys, xs)  # N,ph,sr,pw,sr,C
        return vals.mean(dim=(2, 4)).permute(0, 3, 1, 2)

    return apply_multi(fn, [_in(data), _in(rois)], "roi_align")


def roi_pooling(data, rois, pooled_size: Tuple[int, int], spatial_scale: float = 1.0):
    """ROIPooling: the max over each quantized bin, sampled on a fixed 4 x
    4 grid a bin (the JAX package's static-shape form)."""
    ph, pw = pooled_size
    sr = 4

    def fn(x, r):
        H, W = x.shape[-2], x.shape[-1]
        f, dev = r.dtype, r.device
        bidx = r[:, 0].to(torch.int32).long()
        x1 = torch.round(r[:, 1] * spatial_scale)
        y1 = torch.round(r[:, 2] * spatial_scale)
        x2 = torch.round(r[:, 3] * spatial_scale)
        y2 = torch.round(r[:, 4] * spatial_scale)
        rw = torch.clamp(x2 - x1 + 1, min=1.0)
        rh = torch.clamp(y2 - y1 + 1, min=1.0)
        bin_h = rh / ph
        bin_w = rw / pw
        iy = torch.arange(sr, device=dev, dtype=f) / sr
        gy = y1[:, None, None] + (torch.arange(ph, device=dev, dtype=f)[None, :, None]
                                  + iy[None, None, :]) * bin_h[:, None, None]
        gx = x1[:, None, None] + (torch.arange(pw, device=dev, dtype=f)[None, :, None]
                                  + iy[None, None, :]) * bin_w[:, None, None]
        yi = torch.floor(gy).to(torch.int32).long().clamp(0, H - 1)   # N,ph,sr
        xi = torch.floor(gx).to(torch.int32).long().clamp(0, W - 1)   # N,pw,sr
        vals = x[bidx[:, None, None, None, None], :, yi[:, :, :, None, None],
                 xi[:, None, None, :, :]]                               # N,ph,sr,pw,sr,C
        return vals.amax(dim=(2, 4)).permute(0, 3, 1, 2)

    return apply_multi(fn, [_in(data), _in(rois)], "roi_pooling")


def _corner_iou(a, b):
    """a [..., N, 4], b [..., M, 4] corners -> IoU [..., N, M]."""
    ax1, ay1, ax2, ay2 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx1, by1, bx2, by2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area_a = (ax2 - ax1).clamp(min=0) * (ay2 - ay1).clamp(min=0)
    area_b = (bx2 - bx1).clamp(min=0) * (by2 - by1).clamp(min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros((), dtype=inter.dtype,
                                                             device=inter.device))


def _to_corner(x, fmt: str):
    if fmt == "corner":
        return x
    if fmt == "center":
        cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    raise MXNetError(f"unknown box format {fmt!r}")


def box_iou(lhs, rhs, format: str = "corner"):
    """Pairwise IoU: [N, 4] x [M, 4] -> [N, M]."""
    return apply_multi(lambda a, b: _corner_iou(_to_corner(a, format), _to_corner(b, format)),
                       [_in(lhs), _in(rhs)], "box_iou")


# ------------------------------------------------------------ the NMS sweep

def nms_decisions(boxes, thresh: float, ids=None, rows=None):
    """The sweep's decision matrix of sorted ``boxes`` [B, n, 4]: bool
    [B, rows, n], True where row i's box suppresses row j's (IoU above
    ``thresh``, j after i, the same id when ``ids`` [B, n] is given), for
    the first ``rows`` rows (default n): a row that can never be valid
    (past a top-k) suppresses nothing, so it needs no row. Built an image
    at a time, which bounds the IoU temporaries to one image's."""
    n = boxes.shape[1]
    m = n if rows is None else min(int(rows), n)
    upper = torch.ones(m, n, dtype=torch.bool, device=boxes.device).triu_(1)
    out = torch.empty(boxes.shape[0], m, n, dtype=torch.bool, device=boxes.device)
    for b in range(boxes.shape[0]):
        iou = _corner_iou(boxes[b, :m], boxes[b])
        if ids is not None:
            iou = torch.where(ids[b, :m][:, None] == ids[b][None, :], iou,
                              torch.zeros((), dtype=iou.dtype, device=iou.device))
        torch.logical_and(iou > thresh, upper, out=out[b])
    return out


def nms_sweep_plain(dec, valid):
    """The greedy sweep as the JAX package writes it, every row in turn:
    ``keep &= ~(dec[i] & keep[i] & valid[i])`` (``dec`` already holds
    ``arange > i``), then ``keep & valid``. ``dec`` bool [B, m, n] (rows
    past m suppress nothing), ``valid`` bool [B, n]; returns keep, bool
    [B, n]."""
    keep = torch.ones_like(valid)
    for i in range(dec.shape[1]):
        k_i = keep[:, i] & valid[:, i]
        keep &= ~(dec[:, i] & k_i[:, None])
    return keep & valid


NMS_SWEEP_THREADS = 1024


def nms_sweep(dec, valid):
    """The greedy NMS sweep over the decision matrix ``dec`` (bool [B, m,
    n], m <= n, from :func:`nms_decisions`) and ``valid`` (bool [B, n]):
    keep, bool [B, n]. A CPU tensor runs :func:`nms_sweep_plain`; a CUDA
    tensor launches ``csrc/nms_sweep.cu`` (one CTA an image) or raises."""
    if dec.dim() != 3 or dec.shape[1] > dec.shape[2] or \
            tuple(valid.shape) != (dec.shape[0], dec.shape[2]):
        raise MXNetError(f"nms_sweep: decisions {tuple(dec.shape)} and valid "
                         f"{tuple(valid.shape)} are not [B, m <= n, n] and [B, n]")
    if dec.device.type == "cpu" and valid.device.type == "cpu":
        return nms_sweep_plain(dec, valid)
    if not dec.is_cuda or not valid.is_cuda:
        raise MXNetError(f"nms_sweep: tensors on {dec.device} and {valid.device}")
    if dec.dtype != torch.bool or valid.dtype != torch.bool:
        raise MXNetError(f"nms_sweep takes bool decisions and validity, got {dec.dtype} "
                         f"and {valid.dtype}")
    from .. import _build
    from .int8_gemv import record_launch
    B, m, n = dec.shape
    dec, valid = dec.contiguous(), valid.contiguous()
    keep = torch.empty(B, n, dtype=torch.bool, device=dec.device)
    if B == 0 or n == 0:
        return keep
    lib = _build.library("nms_sweep")
    _build.check(lib.mx_nms_sweep(dec.data_ptr(), valid.data_ptr(), keep.data_ptr(), B, m, n,
                                  NMS_SWEEP_THREADS,
                                  torch.cuda.current_stream(dec.device).cuda_stream),
                 "nms_sweep")
    record_launch("nms_sweep")
    return keep


def box_nms(data, overlap_thresh: float = 0.5, valid_thresh: float = 0.0, topk: int = -1,
            coord_start: int = 2, score_index: int = 1, id_index: int = -1,
            force_suppress: bool = False, in_format: str = "corner",
            out_format: str = "corner"):
    """Non-maximum suppression over ``data`` [N, K] (rows of (..., score,
    box, ...), or [B, N, K]): rows sorted by score, suppressed or invalid
    rows all -1."""
    if out_format != in_format:
        raise MXNetError("box_nms: format conversion not supported")

    def fn(x):
        one = x.dim() == 2
        x = x[None] if one else x
        n, K = x.shape[1], x.shape[2]
        scores = x[..., score_index]
        cs = min(max(coord_start, 0), K - 4)   # lax.dynamic_slice clamps the start
        boxes = _to_corner(x[..., cs:cs + 4], in_format)
        order = torch.argsort(-scores, dim=1, stable=True)
        x_sorted = torch.take_along_dim(x, order[..., None], dim=1)
        scores = torch.take_along_dim(scores, order, dim=1)
        boxes = torch.take_along_dim(boxes, order[..., None], dim=1)
        valid = scores > valid_thresh
        if topk > 0:
            valid = valid & (torch.arange(n, device=x.device) < topk)
        ids = x_sorted[..., id_index] if id_index >= 0 and not force_suppress else None
        rows = topk if topk > 0 else None     # rows past topk are never valid
        keep = nms_sweep(nms_decisions(boxes, overlap_thresh, ids, rows), valid)
        out = torch.where(keep[..., None], x_sorted, -torch.ones_like(x_sorted))
        return out[0] if one else out

    return apply(fn, _in(data), name="box_nms")


# ---------------------------------------------------------- matching, SSD

def bipartite_matching(iou, threshold: float, is_ascend: bool = False, topk: int = -1):
    """Greedy bipartite matching over a score matrix [N, M]: take the best
    pair, retire its row and column, ``min(N, M)`` (or ``topk``) times.
    Returns (row -> column [N], column -> row [M]) as int32, -1 where
    unmatched."""
    def fn(s):
        n, m = s.shape
        k = min(n, m) if topk <= 0 else min(topk, min(n, m))
        sign = 1.0 if is_ascend else -1.0
        cur = s.float().clone()
        rows = torch.full((n,), -1, dtype=torch.int32, device=s.device)
        cols = torch.full((m,), -1, dtype=torch.int32, device=s.device)
        big = torch.full((), sign * float("inf"), device=s.device)
        for _ in range(k):
            flat = torch.argmin(sign * cur)
            i, j = flat // m, flat % m
            val = cur[i, j]
            good = (val < threshold) if is_ascend else (val > threshold)
            rows[i] = torch.where(good, j.to(torch.int32), rows[i])
            cols[j] = torch.where(good, i.to(torch.int32), cols[j])
            cur[i, :] = big
            cur[:, j] = big
        return rows, cols

    return apply(fn, _in(iou), name="bipartite_matching")


def _variances(variances, device):
    return torch.tensor(variances, dtype=torch.float32, device=device)


def _anchor_centers(a):
    aw = torch.clamp(a[:, 2] - a[:, 0], min=1e-8)
    ah = torch.clamp(a[:, 3] - a[:, 1], min=1e-8)
    return aw, ah, (a[:, 0] + a[:, 2]) / 2, (a[:, 1] + a[:, 3]) / 2


def multibox_target(anchors, labels, cls_preds, overlap_threshold: float = 0.5,
                    ignore_label: float = -1.0, negative_mining_ratio: float = -1.0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD anchor matching and box-offset encoding: ``anchors`` [1, A, 4]
    corners, ``labels`` [B, M, 5] rows of (class, x1, y1, x2, y2) padded
    with -1, ``cls_preds`` [B, C, A] (its shape only; no hard negative
    mining, as in the JAX package). Returns (loc_target [B, A*4], loc_mask
    [B, A*4], cls_target [B, A]), class 0 the background."""
    def fn(anc, lab):
        v = _variances(variances, anc.device)
        a = anc[0]
        aw, ah, acx, acy = _anchor_centers(a)
        A, M = a.shape[0], lab.shape[1]
        valid = lab[..., 0] >= 0                                   # B,M
        gt = lab[..., 1:5]
        iou = _corner_iou(a[None], gt)                             # B,A,M
        iou = torch.where(valid[:, None, :], iou, torch.full((), -1.0, dtype=iou.dtype,
                                                               device=iou.device))
        best_anchor = torch.argmax(iou, dim=1)                     # B,M
        best_iou = iou.amax(dim=2)                                 # B,A
        best_gt = torch.argmax(iou, dim=2)
        matched = best_iou >= overlap_threshold
        # each valid gt claims its best anchor; of several claims on one
        # anchor the last gt wins (the JAX package's scatter in order)
        claims = (best_anchor[:, None, :] == torch.arange(A, device=a.device)[None, :, None]) \
            & valid[:, None, :]                                    # B,A,M
        forced = claims.any(dim=2)
        last = torch.where(claims, torch.arange(M, device=a.device), -1).amax(dim=2)
        gt_idx = torch.where(forced & (last >= 0), last, best_gt)
        is_match = matched | forced
        g = torch.take_along_dim(gt, gt_idx[..., None], dim=1)    # B,A,4
        gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-8)
        gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-8)
        gcx = (g[..., 0] + g[..., 2]) / 2
        gcy = (g[..., 1] + g[..., 3]) / 2
        loc = torch.stack([(gcx - acx) / aw / v[0], (gcy - acy) / ah / v[1],
                           torch.log(gw / aw) / v[2], torch.log(gh / ah) / v[3]], dim=-1)
        mask = is_match[..., None].to(torch.float32)
        cls = torch.where(is_match, torch.take_along_dim(lab[..., 0], gt_idx, dim=1) + 1.0,
                          torch.zeros((), dtype=lab.dtype, device=lab.device))
        B = lab.shape[0]
        return (loc * mask).reshape(B, -1), mask.expand(B, A, 4).reshape(B, -1), cls

    return apply_multi(fn, [_in(anchors), _in(labels)], "multibox_target")


def multibox_detection(cls_prob, loc_pred, anchors, clip: bool = True, threshold: float = 0.01,
                       nms_threshold: float = 0.5, force_suppress: bool = False,
                       nms_topk: int = -1, variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD decode and per-image NMS: ``cls_prob`` [B, C, A] (class 0 the
    background), ``loc_pred`` [B, A*4], ``anchors`` [1, A, 4]. Returns [B,
    A, 6] rows of (class id, score, x1, y1, x2, y2) sorted by score,
    suppressed rows all -1."""
    def fn(cp, lp, anc):
        v = _variances(variances, anc.device)
        aw, ah, acx, acy = _anchor_centers(anc[0])
        B = cp.shape[0]
        loc = lp.reshape(B, -1, 4)
        cx = loc[..., 0] * v[0] * aw + acx
        cy = loc[..., 1] * v[1] * ah + acy
        w = torch.exp(loc[..., 2] * v[2]) * aw
        h = torch.exp(loc[..., 3] * v[3]) * ah
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        if clip:
            boxes = boxes.clamp(0.0, 1.0)
        score = cp[:, 1:].amax(dim=1)                             # best non-background
        cid = torch.argmax(cp[:, 1:], dim=1).to(cp.dtype)
        keep_score = score > threshold
        neg = torch.full((), -1.0, dtype=cp.dtype, device=cp.device)
        rows = torch.cat([torch.where(keep_score, cid, neg)[..., None],
                          torch.where(keep_score, score, neg)[..., None], boxes], -1)
        order = torch.argsort(-rows[..., 1], dim=1, stable=True)
        rows = torch.take_along_dim(rows, order[..., None], dim=1)
        n = rows.shape[1]
        valid = rows[..., 1] > 0
        if nms_topk > 0:
            valid = valid & (torch.arange(n, device=rows.device) < nms_topk)
        ids = None if force_suppress else rows[..., 0]
        m = nms_topk if nms_topk > 0 else None     # rows past nms_topk are never valid
        keep = nms_sweep(nms_decisions(rows[..., 2:6], nms_threshold, ids, m), valid)
        return torch.where(keep[..., None], rows, -torch.ones_like(rows))

    return apply_multi(fn, [_in(cls_prob), _in(loc_pred), _in(anchors)],
                       "multibox_detection")


# -------------------------------------------------------- deformable conv

def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3), stride=(1, 1),
                           pad=(0, 0), dilate=(1, 1), num_filter=None,
                           num_deformable_group: int = 1, num_group: int = 1,
                           no_bias: bool = False):
    """Deformable convolution v1: ``data`` [B, C, H, W], ``offset`` [B,
    2*G*KH*KW, OH, OW] of (dy, dx) pairs per tap and deformable group G,
    ``weight`` [O, C, KH, KW]. The deformable im2col is one batched
    bilinear gather over the tap grid (zero padding), the contraction one
    einsum."""
    if num_group != 1:
        raise MXNetError("deformable_convolution: num_group>1 not supported")
    kh, kw = kernel
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    dh, dw = (dilate, dilate) if isinstance(dilate, int) else dilate
    G = num_deformable_group
    d_arr, o_arr, w_arr = _in(data), _in(offset), _in(weight)
    K = kh * kw
    B, C, H, W = d_arr.shape
    OH = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    OW = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if C % G != 0:
        raise MXNetError(f"deformable_convolution: channels {C} not divisible by "
                         f"num_deformable_group {G}")
    if tuple(o_arr.shape) != (B, 2 * G * K, OH, OW):
        raise MXNetError(f"deformable_convolution: offset shape {tuple(o_arr.shape)} != "
                         f"expected {(B, 2 * G * K, OH, OW)} "
                         "(= [B, 2·groups·KH·KW, out_h, out_w])")
    if tuple(w_arr.shape[1:]) != (C, kh, kw):
        raise MXNetError(f"deformable_convolution: weight shape {tuple(w_arr.shape)} "
                         f"incompatible with C={C}, kernel={kernel}")
    if num_filter is not None and w_arr.shape[0] != num_filter:
        raise MXNetError(f"deformable_convolution: num_filter={num_filter} but weight has "
                         f"{w_arr.shape[0]} output channels")

    def fn(x, off, w, *rest):
        dev, f = x.device, off.dtype
        oy = torch.arange(OH, device=dev) * sh - ph
        ox = torch.arange(OW, device=dev) * sw - pw
        ty = torch.arange(kh, device=dev) * dh
        tx = torch.arange(kw, device=dev) * dw
        base_y = (oy[:, None, None, None] + ty[None, None, :, None]).expand(OH, OW, kh, kw)
        base_x = (ox[None, :, None, None] + tx[None, None, None, :]).expand(OH, OW, kh, kw)
        base_y = base_y.reshape(OH, OW, K).to(f)
        base_x = base_x.reshape(OH, OW, K).to(f)
        o = off.reshape(B, G, K, 2, OH, OW)
        ys = base_y + o[:, :, :, 0].permute(0, 1, 3, 4, 2)       # B,G,OH,OW,K
        xs = base_x + o[:, :, :, 1].permute(0, 1, 3, 4, 2)
        feats = x.reshape(B, G, C // G, H, W)
        bidx = torch.arange(B, device=dev)[:, None, None, None, None]
        gidx = torch.arange(G, device=dev)[None, :, None, None, None]
        cols = _bilinear_sample_zeropad(feats, bidx, gidx, ys, xs)  # B,G,OH,OW,K,cg
        cols = cols.permute(0, 1, 5, 2, 3, 4).reshape(B, C, OH, OW, K)
        y = torch.einsum("bchwk,ock->bohw", cols, w.reshape(w.shape[0], C, K))
        if rest:
            y = y + rest[0][None, :, None, None]
        return y

    arrays = [d_arr, o_arr, w_arr]
    if bias is not None and not no_bias:
        arrays.append(_in(bias))
    return apply_multi(fn, arrays, "deformable_convolution")
