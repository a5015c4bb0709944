"""Detection operators (counterpart of ``mxnet_tpu/ops/detection_ops.py``):
the box ops, SSD's MultiBox family, Faster R-CNN's Proposal and ROI
pooling, R-FCN's PSROIPooling and DCNv1's deformable convolution.

Fixed shapes, as in the reference: NMS marks a suppressed row with score
(and id) -1 instead of dropping it, and every loop runs a static number of
steps, vectorised over the batch, so nothing is read back to the host.
Where the reference's result depends on an order, the port pins the same
one:

- sorts are stable (``jnp.argsort``), and a top-k breaks ties by the lower
  index (``lax.top_k``), through ``torch.sort(stable=True)``;
- an argmax takes the first maximum, in both packages;
- MultiBoxTarget's force-match writes the ground-truth row of each anchor
  with duplicate anchors, where XLA's scatter keeps the last write: the
  port takes the largest row index (``scatter_reduce`` "amax"), whatever
  order the card's atomics run in.

``box_nms``'s greedy sweep is sequential: one step per candidate, over the
score-sorted rows.  A row past ``topk`` is never kept and so never
suppresses, so the sweep and its IoU matrix stop at min(N, topk) rows.  The
IoU matrix is built a few images at a time (an SSD-300 batch of 32 holds
8732 anchors an image: 9.8 GB of fp32 IoU at once), and only its boolean
overlap is kept.
"""
from __future__ import annotations

import math

import torch

from .numerics import div_scalar
from .registry import register

# elements of one chunk's IoU matrix (fp32) in box_nms
_NMS_CHUNK = 1 << 26


# --------------------------------------------------------------------------
# box utilities
# --------------------------------------------------------------------------
def _relu(x):
    """max(x, 0) with jnp.maximum's gradient (half at a tie)."""
    return torch.maximum(x, torch.zeros_like(x))


def _box_area(boxes, fmt):
    if fmt == "corner":
        return _relu(boxes[..., 2] - boxes[..., 0]) * \
            _relu(boxes[..., 3] - boxes[..., 1])
    return boxes[..., 2] * boxes[..., 3]


def _to_corner(boxes, fmt):
    if fmt == "corner":
        return boxes
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _pairwise_iou(a, b, fmt="corner"):
    """The IoU matrix of (..., N, 4) and (..., M, 4) boxes."""
    a, b = _to_corner(a, fmt), _to_corner(b, fmt)
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = _relu(br - tl)
    inter = wh[..., 0] * wh[..., 1]
    union = _box_area(a, "corner")[..., :, None] + \
        _box_area(b, "corner")[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


@register("_contrib_box_iou", aliases=("box_iou",))
def box_iou(lhs, rhs, format="corner"):
    return _pairwise_iou(lhs, rhs, format)


def _stable_order(key, descending=False):
    """Indices of a stable sort of ``key`` along its last axis."""
    return torch.sort(key, dim=-1, descending=descending, stable=True)[1]


def nms_keep(overlap, keep, steps):
    """The greedy sweep: for i < ``steps`` in order, a kept row i clears
    ``keep`` at every later row it overlaps.  ``overlap`` (B, K, K) bool
    holds only pairs (i, j > i); ``keep`` (B, K) bool is the rows that may
    be kept."""
    keep = keep.clone()
    for i in range(steps):
        keep &= ~(overlap[:, i] & keep[:, i:i + 1])
    return keep


@register("_contrib_box_nms", aliases=("box_nms",), differentiable=False)
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Non-maximum suppression over (..., N, K) rows [id?, score, box...]:
    the rows sorted by score (stable, so ties keep their order), then each
    one not suppressed suppresses the later rows of its class (every row
    with ``force_suppress``) whose IoU with it exceeds ``overlap_thresh``.
    A row at or below ``valid_thresh``, past ``topk``, or suppressed has
    score (and id) -1; the output keeps the input's shape, in the sorted
    order."""
    shape = data.shape
    n, width = shape[-2], shape[-1]
    x = data.reshape(-1, n, width)
    b = x.shape[0]
    scores = x[:, :, score_index]
    valid = scores > valid_thresh
    order = _stable_order(-torch.where(valid, scores,
                                       torch.full_like(scores, -math.inf)))
    xs = torch.gather(x, 1, order[:, :, None].expand(b, n, width))
    steps = n if topk <= 0 else min(n, int(topk))
    cand = torch.gather(valid, 1, order)[:, :steps]
    boxes = xs[:, :steps, coord_start:coord_start + 4]
    later = torch.ones(steps, steps, dtype=torch.bool,
                       device=x.device).triu(1)
    per_class = id_index >= 0 and not force_suppress
    chunk = max(1, _NMS_CHUNK // max(1, steps * steps))
    overlap = []
    for s in range(0, b, chunk):
        iou = _pairwise_iou(boxes[s:s + chunk], boxes[s:s + chunk],
                            in_format)
        over = (iou > overlap_thresh) & later & cand[s:s + chunk, None, :]
        if per_class:
            ids = xs[s:s + chunk, :steps, id_index]
            over &= ids[:, :, None] == ids[:, None, :]
        overlap.append(over)
    keep = nms_keep(torch.cat(overlap), cand, steps)
    keep = torch.cat([keep, keep.new_zeros(b, n - steps)], dim=1)
    out = xs.clone()
    neg = torch.full_like(scores, -1.0)
    out[:, :, score_index] = torch.where(keep, xs[:, :, score_index], neg)
    if id_index >= 0:
        out[:, :, id_index] = torch.where(keep, xs[:, :, id_index], neg)
    return out.reshape(shape)


# --------------------------------------------------------------------------
# ROI pooling
# --------------------------------------------------------------------------
def _sparse_table(t):
    """Level k holds max(t[..., i:i + 2^k]) along the last axis (-inf past
    the end), for 2^k <= length: (levels, *t.shape)."""
    n = t.shape[-1]
    levels = [t]
    span = 1
    while 2 * span <= n:
        prev = levels[-1]
        shifted = torch.cat([prev[..., span:], torch.full_like(
            prev[..., :span], -math.inf)], dim=-1)
        levels.append(torch.maximum(prev, shifted))
        span *= 2
    return torch.stack(levels)


def _floor_log2(length, most):
    """floor(log2(length)) for lengths 1..``most``, by table (exact on
    every device, where a float log2 need not be)."""
    table = torch.tensor([max(i, 1).bit_length() - 1 for i in range(
        most + 1)], device=length.device)
    return table[length]


def _range_max_pool(data, b, lo, hi, lo2, hi2):
    """Max over data[b_r, :, lo2:hi2, lo:hi] for each ROI r and bin (py,
    px): ``lo``/``hi`` (R, pw) column bounds, ``lo2``/``hi2`` (R, ph) row
    bounds, clipped to the map; -inf for an empty bin.  Two range-max
    queries on sparse tables (columns, then rows), so no (R, C, H, W)
    tensor is made."""
    _, c, h, w = data.shape
    r = b.shape[0]
    lo, hi = torch.clamp(lo, 0, w), torch.clamp(hi, 0, w)
    lo2, hi2 = torch.clamp(lo2, 0, h), torch.clamp(hi2, 0, h)
    empty_x, empty_y = hi <= lo, hi2 <= lo2
    lo = torch.where(empty_x, torch.zeros_like(lo), lo)
    hi = torch.where(empty_x, torch.ones_like(hi), hi)
    lo2 = torch.where(empty_y, torch.zeros_like(lo2), lo2)
    hi2 = torch.where(empty_y, torch.ones_like(hi2), hi2)
    # columns: table over W of the whole map, queried per (ROI, px)
    tab = _sparse_table(data)                         # (Kx, N, C, H, W)
    k = _floor_log2(hi - lo, w)                        # (R, pw)
    bb = b[:, None]
    cols = torch.maximum(tab[k, bb, :, :, lo],
                         tab[k, bb, :, :, hi - 2 ** k])   # (R, pw, C, H)
    # rows: table over H of the column maxima, queried per (ROI, py)
    tab2 = _sparse_table(cols)                        # (Ky, R, pw, C, H)
    k2 = _floor_log2(hi2 - lo2, h)                     # (R, ph)
    rr = torch.arange(r, device=data.device)[:, None]
    out = torch.maximum(tab2[k2, rr, :, :, lo2],
                        tab2[k2, rr, :, :, hi2 - 2 ** k2])  # (R,ph,pw,C)
    empty = empty_y[:, :, None] | empty_x[:, None, :]
    out = torch.where(empty[..., None], torch.full_like(out, -math.inf), out)
    return out.permute(0, 3, 1, 2)


@register("ROIPooling", aliases=("roi_pooling",))
def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max over each bin of each ROI: ``data`` (N, C, H, W), ``rois``
    (R, 5) rows [batch, x1, y1, x2, y2]; the ROI rounded to the map's
    pixels, bin (py, px) the pixels floor(y1 + py * h / ph) ..
    ceil(y1 + (py + 1) * h / ph) - 1 (and so for x); an empty or
    non-finite bin gives 0."""
    if isinstance(pooled_size, int):
        pooled_size = (pooled_size, pooled_size)
    ph, pw = pooled_size
    b = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale)
                      for i in range(1, 5))
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    px = torch.arange(pw, device=data.device)
    py = torch.arange(ph, device=data.device)
    xs = torch.floor(x1[:, None] + div_scalar(px * rw[:, None], pw))
    xe = torch.ceil(x1[:, None] + div_scalar((px + 1) * rw[:, None], pw))
    ys = torch.floor(y1[:, None] + div_scalar(py * rh[:, None], ph))
    ye = torch.ceil(y1[:, None] + div_scalar((py + 1) * rh[:, None], ph))
    v = _range_max_pool(data, b, xs.to(torch.int64), xe.to(torch.int64),
                        ys.to(torch.int64), ye.to(torch.int64))
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def _bilinear_corners(y, x, h, w):
    """The four corners' indices and weights of bilinear sampling at
    (y, x), clipped to the map, as ROIAlign computes them."""
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1).to(torch.int64)
    x1 = torch.clamp(x0 + 1, 0, w - 1).to(torch.int64)
    ly = torch.clamp(y - y0, 0, 1)
    lx = torch.clamp(x - x0, 0, 1)
    return y0.to(torch.int64), x0.to(torch.int64), y1, x1, ly, lx


@register("_contrib_ROIAlign", aliases=("ROIAlign", "roi_align"))
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, aligned=False):
    """Bilinear ROI align: each bin the mean of sample_ratio^2 bilinear
    samples at its sub-cell centres."""
    if isinstance(pooled_size, int):
        pooled_size = (pooled_size, pooled_size)
    ph, pw = pooled_size
    n, c, h, w = data.shape
    sr = max(int(sample_ratio), 1)
    offset = 0.5 if aligned else 0.0
    b = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale - offset
                      for i in range(1, 5))
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bin_w, bin_h = div_scalar(rw, pw), div_scalar(rh, ph)
    ys = y1[:, None] + div_scalar((torch.arange(
        ph * sr, device=data.device) + 0.5) * bin_h[:, None], sr)
    xs = x1[:, None] + div_scalar((torch.arange(
        pw * sr, device=data.device) + 0.5) * bin_w[:, None], sr)
    yy = ys[:, :, None].expand(-1, -1, pw * sr)
    xx = xs[:, None, :].expand(-1, ph * sr, -1)
    y0, x0, y1i, x1i, ly, lx = _bilinear_corners(yy, xx, h, w)
    bb = b[:, None, None]

    def at(yi, xi):
        return data[bb, :, yi, xi]                   # (R, ph*sr, pw*sr, C)

    ly, lx = ly[..., None], lx[..., None]
    val = (at(y0, x0) * (1 - ly) * (1 - lx) + at(y0, x1i) * (1 - ly) * lx
           + at(y1i, x0) * ly * (1 - lx) + at(y1i, x1i) * ly * lx)
    val = val.reshape(-1, ph, sr, pw, sr, c).mean(dim=(2, 4))
    return val.permute(0, 3, 1, 2)


@register("_contrib_PSROIPooling", aliases=("PSROIPooling", "psroi_pooling"))
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=None,
                  pooled_size=7, group_size=None, sample_per_part=2):
    """R-FCN's position-sensitive pooling: ``data`` (N, output_dim * g * g,
    H, W); bin (i, j) of each ROI averages sample_per_part^2 bilinear
    samples of channel group i * g + j.  Output (R, output_dim, g, g)."""
    from ..base import MXNetError

    g = group_size or pooled_size
    _, ctot, hh, ww = data.shape
    if output_dim is not None and ctot != output_dim * g * g:
        raise MXNetError(
            f"PSROIPooling: {ctot} channels != output_dim*group_size^2 "
            f"({output_dim}*{g}^2={output_dim * g * g})")
    s = sample_per_part
    dev = data.device
    b = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale for i in range(1, 5))
    bw = div_scalar(torch.clamp(x2 - x1, min=0.1), g)
    bh = div_scalar(torch.clamp(y2 - y1, min=0.1), g)
    cells = torch.arange(g, device=dev)
    sub = div_scalar(torch.arange(s, device=dev) + 0.5, s)
    grid = cells[:, None] + sub[None, :]                       # (g, s)
    yy = torch.clamp(y1[:, None, None] + grid * bh[:, None, None], 0, hh - 1)
    xx = torch.clamp(x1[:, None, None] + grid * bw[:, None, None], 0, ww - 1)
    y0 = torch.floor(yy).to(torch.int64)
    x0 = torch.floor(xx).to(torch.int64)
    wy, wx = yy - y0, xx - x0                                  # (R, g, s)
    y1i = torch.clamp(y0 + 1, max=hh - 1)
    x1i = torch.clamp(x0 + 1, max=ww - 1)
    dim = ctot // (g * g)
    ch = (torch.arange(dim, device=dev)[:, None, None] * g * g
          + cells[:, None] * g + cells[None, :])              # (dim, g, g)
    bidx = b[:, None, None, None, None, None]
    chi = ch[None, :, :, :, None, None]

    def gather(yi, xi):          # -> (R, dim, gy, gx, sy, sx)
        return data[bidx, chi, yi[:, None, :, None, :, None],
                    xi[:, None, None, :, None, :]]

    wy_b = wy[:, None, :, None, :, None]
    wx_b = wx[:, None, None, :, None, :]
    out = (gather(y0, x0) * ((1 - wy_b) * (1 - wx_b))
           + gather(y1i, x0) * (wy_b * (1 - wx_b))
           + gather(y0, x1i) * ((1 - wy_b) * wx_b)
           + gather(y1i, x1i) * (wy_b * wx_b))
    return out.mean(dim=(4, 5)).to(data.dtype)


# --------------------------------------------------------------------------
# SSD's MultiBox family
# --------------------------------------------------------------------------
@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",
                                             "multibox_prior"),
          differentiable=False)
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors of an (N, C, H, W) feature map: (1, H * W * (S + R - 1), 4)
    corner boxes, at each position the first size with every ratio, then
    the other sizes with the first ratio."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    step_y = steps[1] if steps[1] > 0 else 1.0 / h
    step_x = steps[0] if steps[0] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_x
    cyy, cxx = torch.meshgrid(cy, cx, indexing="ij")
    whs = [(sizes[0] * math.sqrt(r), sizes[0] / math.sqrt(r))
           for r in ratios]
    whs += [(s * math.sqrt(ratios[0]), s / math.sqrt(ratios[0]))
            for s in sizes[1:]]
    anchors = [torch.stack([cxx - aw / 2, cyy - ah / 2, cxx + aw / 2,
                            cyy + ah / 2], dim=-1) for aw, ah in whs]
    out = torch.stack(anchors, dim=2).reshape(1, -1, 4)
    return torch.clamp(out, 0.0, 1.0) if clip else out


def _center_size(boxes):
    return ((boxes[..., 0] + boxes[..., 2]) / 2,
            (boxes[..., 1] + boxes[..., 3]) / 2)


def force_match_rows(safe, na):
    """For each of ``na`` anchors, the last ground-truth row (of (N, M)
    ``safe``, each row's best anchor or ``na`` for padding) that claims it,
    0 where none does: the write XLA's scatter keeps, whatever order the
    card's atomics run in."""
    nb, m = safe.shape
    rows = torch.arange(m, device=safe.device).expand(nb, m)
    gt_of = torch.zeros(nb, na + 1, dtype=torch.int64, device=safe.device)
    return gt_of.scatter_reduce(1, safe, rows, reduce="amax")[:, :na]


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",
                                              "multibox_target"),
          differentiable=False, nout=3)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1, negative_mining_ratio=-1,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors (1, A, 4) to the ground truth ``label`` (N, M, 5)
    rows [class, x1, y1, x2, y2] (class < 0: padding) and encode the box
    targets.  An anchor matches its best row at IoU >= the threshold, and
    each valid row claims its best anchor (of two rows with the same best
    anchor, the later one).  With ``negative_mining_ratio`` > 0 the
    unmatched anchors below ``negative_mining_thresh`` rank by their best
    non-background score in ``cls_pred`` (N, classes + 1, A), stably: the
    top ratio * matches (at least ``minimum_negative_samples``) are
    background, the rest ``ignore_label``.  Returns the box targets
    (N, A * 4), their mask (N, A * 4) and the class targets (N, A)."""
    anchors = anchor.reshape(-1, 4)
    na = anchors.shape[0]
    nb, m = label.shape[0], label.shape[1]
    acx, acy = _center_size(anchors)
    aw = torch.clamp(anchors[:, 2] - anchors[:, 0], min=1e-12)
    ah = torch.clamp(anchors[:, 3] - anchors[:, 1], min=1e-12)
    gt_valid = label[:, :, 0] >= 0                                # (N, M)
    iou = _pairwise_iou(anchors, label[:, :, 1:5])                # (N, A, M)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = torch.amax(iou, dim=2)
    best_gt = torch.argmax(iou, dim=2)
    matched = best_iou >= overlap_threshold
    # force-match: a padded row scatters to the spare column na
    best_anchor = torch.argmax(iou, dim=1)                        # (N, M)
    safe = torch.where(gt_valid, best_anchor, torch.full_like(
        best_anchor, na))
    gt_of = force_match_rows(safe, na)
    forced = torch.zeros(nb, na + 1, dtype=torch.bool, device=label.device)
    forced = forced.scatter(1, safe, True)[:, :na]
    use_gt = torch.where(forced, gt_of, best_gt)
    matched = matched | forced
    g = torch.gather(label, 1, use_gt[:, :, None].expand(nb, na, 5))
    gcx, gcy = _center_size(g[:, :, 1:5])
    gw = torch.clamp(g[:, :, 3] - g[:, :, 1], min=1e-12)
    gh = torch.clamp(g[:, :, 4] - g[:, :, 2], min=1e-12)
    box_t = torch.stack([div_scalar((gcx - acx) / aw, variances[0]),
                         div_scalar((gcy - acy) / ah, variances[1]),
                         div_scalar(torch.log(gw / aw), variances[2]),
                         div_scalar(torch.log(gh / ah), variances[3])],
                        dim=-1)
    mask = matched[:, :, None].to(box_t.dtype)
    if negative_mining_ratio > 0:
        neg_cand = ~matched & (best_iou < negative_mining_thresh)
        conf = torch.amax(cls_pred[:, 1:, :], dim=1)              # (N, A)
        k = torch.clamp(matched.sum(1).to(torch.float32)
                        * negative_mining_ratio,
                        min=float(minimum_negative_samples))
        score = torch.where(neg_cand, conf, torch.full_like(conf, -math.inf))
        order = _stable_order(-score)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(na, device=order.device).expand(nb, na))
        keep_neg = neg_cand & (rank.to(torch.float32) < k[:, None])
        cls_t = torch.where(
            matched, g[:, :, 0] + 1,
            torch.where(keep_neg, torch.zeros_like(conf),
                        torch.full_like(conf, float(ignore_label))))
    else:
        cls_t = torch.where(matched, g[:, :, 0] + 1,
                            torch.zeros_like(g[:, :, 0]))
    return ((box_t * mask).reshape(nb, -1),
            mask.expand(box_t.shape).reshape(nb, -1), cls_t)


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",
                                                 "multibox_detection"),
          differentiable=False)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """Decode (N, A * 4) offsets at the anchors, take each anchor's best
    non-background class of ``cls_prob`` (N, classes, A), then box_nms:
    (N, A, 6) rows [class, score, x1, y1, x2, y2], -1 where dropped."""
    anchors = anchor.reshape(-1, 4)
    acx, acy = _center_size(anchors)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    loc = loc_pred.reshape(loc_pred.shape[0], -1, 4)
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw
    h = torch.exp(loc[..., 3] * variances[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)
    score = torch.amax(fg, dim=1)
    cls_id = torch.argmax(fg, dim=1).to(boxes.dtype)
    keep = score > threshold
    neg = torch.full_like(score, -1.0)
    det = torch.cat([torch.where(keep, cls_id, neg)[..., None],
                     torch.where(keep, score, neg)[..., None], boxes], dim=-1)
    return box_nms(det, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)


@register("_contrib_bipartite_matching", aliases=("bipartite_matching",),
          differentiable=False, nout=2)
def bipartite_matching(data, threshold=0.5, is_ascend=False, topk=-1):
    """Greedy matching on (..., N, M) scores: repeatedly the best remaining
    pair (the first in row-major order among equals), taken while it beats
    ``threshold``, its row and column then retired.  Returns the row ->
    column and column -> row matches, -1 where unmatched."""
    shape = data.shape
    n, m = shape[-2], shape[-1]
    x = data.reshape(-1, n, m)
    b = x.shape[0]
    big = math.inf if is_ascend else -math.inf
    rounds = min(n, m) if topk <= 0 else min(topk, n, m)
    rmatch = torch.full((b, n), -1.0, device=x.device)
    cmatch = torch.full((b, m), -1.0, device=x.device)
    rows = torch.arange(n, device=x.device)
    cols = torch.arange(m, device=x.device)
    for _ in range(rounds):
        flat = x.reshape(b, -1)
        best = torch.argmin(flat, dim=1) if is_ascend else \
            torch.argmax(flat, dim=1)
        v = torch.gather(flat, 1, best[:, None])[:, 0]
        i, j = best // m, best % m
        ok = (v < threshold) if is_ascend else (v > threshold)
        hit_r = (rows == i[:, None]) & ok[:, None]
        hit_c = (cols == j[:, None]) & ok[:, None]
        rmatch = torch.where(hit_r, j[:, None].to(rmatch.dtype), rmatch)
        cmatch = torch.where(hit_c, i[:, None].to(cmatch.dtype), cmatch)
        retire = (rows == i[:, None])[:, :, None] | \
            (cols == j[:, None])[:, None, :]
        x = torch.where(retire, torch.full_like(x, big), x)
    return (rmatch.reshape(shape[:-2] + (n,)),
            cmatch.reshape(shape[:-2] + (m,)))


# --------------------------------------------------------------------------
# Faster R-CNN's region proposals
# --------------------------------------------------------------------------
def _enum_anchors(feat_h, feat_w, stride, scales, ratios, base_size, device):
    f32 = dict(dtype=torch.float32, device=device)
    base = torch.tensor([0, 0, base_size - 1.0, base_size - 1.0], **f32)
    cx = (base[0] + base[2]) * 0.5
    cy = (base[1] + base[3]) * 0.5
    size = (base[2] - base[0] + 1.0) * (base[3] - base[1] + 1.0)
    anchors = []
    for r in ratios:
        ws = torch.round(torch.sqrt(size / r))
        hs = torch.round(ws * r)
        for s in scales:
            anchors.append(torch.stack([cx - 0.5 * (ws * s - 1),
                                        cy - 0.5 * (hs * s - 1),
                                        cx + 0.5 * (ws * s - 1),
                                        cy + 0.5 * (hs * s - 1)]))
    a = torch.stack(anchors)                                  # (A, 4)
    sx = torch.arange(feat_w, dtype=torch.int32, device=device) * stride
    sy = torch.arange(feat_h, dtype=torch.int32, device=device) * stride
    gx, gy = torch.meshgrid(sx, sy, indexing="xy")
    shift = torch.stack([gx, gy, gx, gy], dim=-1)             # (h, w, 4)
    return (shift[:, :, None, :] + a[None, None]).reshape(-1, 4)


def _bbox_transform_inv(anchors, deltas):
    w = anchors[..., 2] - anchors[..., 0] + 1.0
    h = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = anchors[..., 0] + 0.5 * (w - 1)
    cy = anchors[..., 1] + 0.5 * (h - 1)
    pcx = deltas[..., 0] * w + cx
    pcy = deltas[..., 1] * h + cy
    pw = torch.exp(deltas[..., 2]) * w
    ph = torch.exp(deltas[..., 3]) * h
    return torch.stack([pcx - 0.5 * (pw - 1), pcy - 0.5 * (ph - 1),
                        pcx + 0.5 * (pw - 1), pcy + 0.5 * (ph - 1)], dim=-1)


@register("_contrib_Proposal", aliases=("Proposal", "proposal"),
          differentiable=False, nout="dynamic")
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """RPN proposals: the anchors moved by ``bbox_pred``, clipped to the
    image, too-small boxes scored -1, the top ``rpn_pre_nms_top_n`` by
    score (ties to the lower index), then greedy NMS picking
    ``rpn_post_nms_top_n`` boxes (the best live box each step, the first
    among equals), slots past the survivors padded with the best box.
    ``cls_prob`` (N, 2A, h, w), background maps first; ``bbox_pred``
    (N, 4A, h, w); ``im_info`` (N, 3) [height, width, scale].  Output
    (N * post, 5) rows [batch, x1, y1, x2, y2], and with ``output_score``
    the (N * post, 1) scores."""
    n, a2, h, w = cls_prob.shape
    na = a2 // 2
    dev = cls_prob.device
    anchors = _enum_anchors(h, w, feature_stride, scales, ratios,
                            float(feature_stride), dev)
    fg = cls_prob[:, na:].permute(0, 2, 3, 1).reshape(n, -1)
    deltas = bbox_pred.reshape(n, na, 4, h, w).permute(0, 3, 4, 1, 2) \
        .reshape(n, -1, 4)
    boxes = _bbox_transform_inv(anchors[None], deltas)
    im_h, im_w = im_info[:, 0, None], im_info[:, 1, None]
    zero = torch.zeros_like(boxes[..., 0])
    boxes = torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), im_w - 1.0),
        torch.minimum(torch.maximum(boxes[..., 1], zero), im_h - 1.0),
        torch.minimum(torch.maximum(boxes[..., 2], zero), im_w - 1.0),
        torch.minimum(torch.maximum(boxes[..., 3], zero), im_h - 1.0)],
        dim=-1)
    min_size = rpn_min_size * im_info[:, 2, None]
    ws = boxes[..., 2] - boxes[..., 0] + 1
    hs = boxes[..., 3] - boxes[..., 1] + 1
    fg = torch.where((ws >= min_size) & (hs >= min_size), fg,
                     torch.full_like(fg, -1.0))
    k = min(rpn_pre_nms_top_n, fg.shape[1])
    top_scores, top_idx = torch.sort(fg, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[:, :, None].expand(n, k, 4))
    areas = (top_boxes[..., 2] - top_boxes[..., 0] + 1) * \
        (top_boxes[..., 3] - top_boxes[..., 1] + 1)
    n_out = min(rpn_post_nms_top_n, k)
    live = top_scores.clone()
    picks, vals = [], []
    for _ in range(n_out):
        j = torch.argmax(live, dim=1, keepdim=True)                # (n, 1)
        picks.append(j)
        vals.append(torch.gather(live, 1, j))
        bj = torch.gather(top_boxes, 1, j[:, :, None].expand(n, 1, 4))
        ix1 = torch.maximum(top_boxes[..., 0], bj[..., 0])
        iy1 = torch.maximum(top_boxes[..., 1], bj[..., 1])
        ix2 = torch.minimum(top_boxes[..., 2], bj[..., 2])
        iy2 = torch.minimum(top_boxes[..., 3], bj[..., 3])
        inter = torch.clamp(ix2 - ix1 + 1, min=0.0) * \
            torch.clamp(iy2 - iy1 + 1, min=0.0)
        iou = inter / (areas + torch.gather(areas, 1, j) - inter)
        live = torch.where(iou > threshold, torch.full_like(live, -math.inf),
                           live)
        live = live.scatter(1, j, -math.inf)  # retired even with NMS off
    keep_idx, keep_scores = torch.cat(picks, 1), torch.cat(vals, 1)
    kept = torch.gather(top_boxes, 1, keep_idx[:, :, None].expand(
        n, n_out, 4))
    best = kept[:, :1]
    valid = keep_scores > 0
    out_boxes = torch.where(valid[..., None], kept, best)
    out_scores = torch.where(valid, keep_scores, torch.zeros_like(
        keep_scores))
    pad = rpn_post_nms_top_n - n_out
    if pad > 0:
        out_boxes = torch.cat([out_boxes, best.expand(n, pad, 4)], dim=1)
        out_scores = torch.cat([out_scores, out_scores.new_zeros(n, pad)], 1)
    batch_idx = torch.arange(n, dtype=boxes.dtype, device=dev) \
        .repeat_interleave(rpn_post_nms_top_n)
    rois = torch.cat([batch_idx[:, None], out_boxes.reshape(-1, 4)], dim=1)
    if output_score:
        return rois, out_scores.reshape(-1, 1)
    return rois


# --------------------------------------------------------------------------
# DCNv1's deformable convolution
# --------------------------------------------------------------------------
@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution", "deformable_convolution"))
def deformable_convolution(data, offset, weight, *maybe_bias, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=None, num_group=1,
                           num_deformable_group=1, no_bias=False,
                           workspace=None, layout=None):
    """data (N, C, H, W); offset (N, 2 * dg * kh * kw, oh, ow), (dy, dx)
    per tap; weight (O, C / g, kh, kw).  Each tap samples the map
    bilinearly at its offset position (0 outside the map), then the grouped
    product with the weight; every input has its gradient."""
    n, c, hh, ww = data.shape
    kh, kw = kernel
    sh, sw = stride if stride else (1, 1)
    dh, dw = dilate if dilate else (1, 1)
    ph, pw = pad if pad else (0, 0)
    oh = (hh + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (ww + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = num_deformable_group
    cg = c // dg
    dev = data.device
    base_y = torch.arange(kh, device=dev)[:, None] * dh + \
        torch.arange(oh, device=dev)[None, :] * sh - ph      # (kh, oh)
    base_x = torch.arange(kw, device=dev)[:, None] * dw + \
        torch.arange(ow, device=dev)[None, :] * sw - pw      # (kw, ow)
    off = offset.reshape(n, dg, kh, kw, 2, oh, ow)
    y = base_y[:, None, :, None] + off[:, :, :, :, 0]     # (n,dg,kh,kw,oh,ow)
    x = base_x[None, :, None, :] + off[:, :, :, :, 1]
    y0, x0 = torch.floor(y), torch.floor(x)
    wy, wx = y - y0, x - x0
    img = data.reshape(n, dg, cg, hh * ww)

    def at(yy, xx):
        inb = (yy >= 0) & (yy < hh) & (xx >= 0) & (xx < ww)
        yi = torch.clamp(yy, 0, hh - 1).to(torch.int64)
        xi = torch.clamp(xx, 0, ww - 1).to(torch.int64)
        idx = (yi * ww + xi).reshape(n, dg, 1, -1).expand(n, dg, cg, -1)
        v = torch.gather(img, 3, idx).reshape(n, dg, cg, kh, kw, oh, ow)
        return torch.where(inb[:, :, None], v, torch.zeros_like(v))

    wy, wx = wy[:, :, None], wx[:, :, None]
    cols = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0 + 1, x0) * wy * (1 - wx)
            + at(y0, x0 + 1) * (1 - wy) * wx
            + at(y0 + 1, x0 + 1) * wy * wx)        # (n, dg, cg, kh,kw,oh,ow)
    cpg = c // num_group
    opg = num_filter // num_group
    cols = cols.reshape(n, num_group, cpg * kh * kw, oh * ow)
    w_g = weight.reshape(num_group, opg, cpg * kh * kw)
    out = torch.matmul(w_g[None], cols).reshape(n, num_filter, oh, ow)
    if maybe_bias and not no_bias:
        out = out + maybe_bias[0].reshape(1, -1, 1, 1)
    return out.to(data.dtype)
