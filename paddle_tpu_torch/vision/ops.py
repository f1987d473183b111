"""Vision ops — port of ``paddle_tpu/vision/ops.py`` (``paddle.vision.ops``):
the RoI family, deformable convolution, the box utilities, the YOLO head
and loss, and the NMS family.

The dense ops run as plain PyTorch where their tensors are (the card by
default) and are differentiable where the JAX package's are:
``box_coder``, ``yolo_box``, ``yolo_loss``, ``roi_align``, ``roi_pool``,
``psroi_pool`` and ``deform_conv2d``. No module here reaches a Pallas
kernel in the JAX package (its RoI ops are ``vmap``ped gathers, its
deformable convolution a gather and one einsum), so none launches a
kernel of the port's own: the products stay ``torch.matmul``. The ops
with data-dependent output shapes (``nms``, ``matrix_nms``,
``distribute_fpn_proposals``, ``generate_proposals``, ``prior_box``) run in
numpy on the host, as there: their inputs are read back with
``.detach().cpu()`` (bf16 widened to fp32), and their results come back as
tensors on the device of their first tensor input.

Quirks of the JAX package that the port keeps, so that both give the same
numbers: ``roi_align`` samples one point a bin, at its centre, whatever
``sampling_ratio`` says, clamping the corner indices into the map and the
interpolation weights to [0, 1]; ``roi_pool`` rounds the box to whole
cells and ``psroi_pool`` averages over floor / ceil bin edges.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn.initializer import Uniform
from ..nn.layer_base import Layer
from ..tensor._util import host_numpy

__all__ = ["DeformConv2D", "PSRoIPool", "RoIAlign", "RoIPool", "box_coder",
           "decode_jpeg", "deform_conv2d", "distribute_fpn_proposals",
           "generate_proposals", "matrix_nms", "nms", "prior_box",
           "psroi_pool", "read_file", "roi_align", "roi_pool", "yolo_box",
           "yolo_loss"]

# elements a chunk of RoIs may materialise in roi_pool / psroi_pool
_CHUNK_ELEMS = 1 << 26


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _out(array, device) -> torch.Tensor:
    """A host op's numpy result as a tensor on ``device`` (a copy: the
    array may be read-only, as a decoded image is)."""
    return torch.from_numpy(np.array(array, order="C")).to(device)


# ---------------------------------------------------------------- NMS family

def _np_iou_matrix(b):
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    xx1 = np.maximum(b[:, None, 0], b[None, :, 0])
    yy1 = np.maximum(b[:, None, 1], b[None, :, 1])
    xx2 = np.minimum(b[:, None, 2], b[None, :, 2])
    yy2 = np.minimum(b[:, None, 3], b[None, :, 3])
    inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
    return inter / (areas[:, None] + areas[None, :] - inter + 1e-10)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy NMS on the host (its output length depends on the data):
    the kept indices, int64, by falling score."""
    b = host_numpy(boxes)
    s = host_numpy(scores) if scores is not None else np.arange(
        len(b), 0, -1, dtype=np.float32)

    def _single(idxs):
        bb, ss = b[idxs], s[idxs]
        order = np.argsort(-ss)
        keep = []
        suppressed = np.zeros(len(bb), bool)
        iou = _np_iou_matrix(bb)
        for i_ in order:
            if suppressed[i_]:
                continue
            keep.append(idxs[i_])
            suppressed |= iou[i_] > iou_threshold
            suppressed[i_] = True
        return keep

    if category_idxs is None:
        keep = _single(np.arange(len(b)))
    else:
        cats = host_numpy(category_idxs)
        keep = []
        for c in (categories if categories is not None else np.unique(cats)):
            keep.extend(_single(np.nonzero(cats == int(c))[0]))
        keep.sort(key=lambda i_: -s[i_])
    keep = np.asarray(keep, np.int64)
    if top_k is not None:
        keep = keep[:top_k]
    return _out(keep, _device_of(boxes))


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2): decayed scores instead of hard suppression, on
    the host."""
    bxs = host_numpy(bboxes)  # [N, M, 4]
    scs = host_numpy(scores)  # [N, C, M]
    out, out_idx, rois_num = [], [], []
    for n in range(bxs.shape[0]):
        dets = []
        for c in range(scs.shape[1]):
            if c == background_label:
                continue
            s = scs[n, c]
            sel = np.nonzero(s > score_threshold)[0]
            if sel.size == 0:
                continue
            sel = sel[np.argsort(-s[sel])][:nms_top_k]
            bb, ss = bxs[n, sel], s[sel]
            iou = _np_iou_matrix(bb)
            # iou_max[j] = max IoU of box j with any higher-scored box
            low = np.tril(iou, -1)
            iou_max = np.concatenate([[0.0], low[1:, :].max(axis=1)
                                      if len(bb) > 1 else np.zeros(0)])
            if use_gaussian:
                decay_m = np.exp((iou_max[None, :] ** 2 - iou ** 2)
                                 * gaussian_sigma)
            else:
                decay_m = (1 - iou) / (1 - iou_max[None, :] + 1e-10)
            # decay for box i = min(1, min_{j<i} decay(iou_ij, iou_max_j))
            decay_m = np.where(np.tril(np.ones_like(iou), -1) > 0, decay_m,
                               1.0)
            decay = np.minimum(decay_m.min(axis=1), 1.0)
            ds = ss * decay
            for j in range(len(sel)):
                if ds[j] > post_threshold:
                    dets.append((c, ds[j], bb[j], n * scs.shape[2] + sel[j]))
        dets.sort(key=lambda d: -d[1])
        dets = dets[:keep_top_k]
        rois_num.append(len(dets))
        for c, sc, bb, gi in dets:
            out.append([c, sc, *bb])
            out_idx.append(gi)
    dev = _device_of(bboxes)
    out_t = _out(np.asarray(out, np.float32).reshape(-1, 6), dev)
    res = [out_t]
    if return_index:
        res.append(_out(np.asarray(out_idx, np.int64), dev))
    if return_rois_num:
        res.append(_out(np.asarray(rois_num, np.int32), dev))
    return tuple(res) if len(res) > 1 else out_t


# ------------------------------------------------------------- box utilities

def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode boxes against priors, or decode deltas back to boxes."""
    pb, tb = prior_box, target_box
    if prior_box_var is None:
        pbv = torch.ones(4, dtype=pb.dtype, device=pb.device)
    else:
        pbv = torch.as_tensor(prior_box_var, dtype=pb.dtype,
                              device=pb.device)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[..., 2] - pb[..., 0] + norm
    ph = pb[..., 3] - pb[..., 1] + norm
    pcx = pb[..., 0] + pw * 0.5
    pcy = pb[..., 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = tb[..., 2] - tb[..., 0] + norm
        th = tb[..., 3] - tb[..., 1] + norm
        tcx = tb[..., 0] + tw * 0.5
        tcy = tb[..., 1] + th * 0.5
        out = torch.stack([(tcx[:, None] - pcx[None, :]) / pw[None, :],
                           (tcy[:, None] - pcy[None, :]) / ph[None, :],
                           torch.log(tw[:, None] / pw[None, :]),
                           torch.log(th[:, None] / ph[None, :])], dim=-1)
        return out / torch.broadcast_to(pbv, out.shape)
    # decode_center_size: target [N, M, 4] deltas against priors broadcast
    # on `axis`
    d = tb * torch.broadcast_to(pbv, tb.shape)

    def exp(v):
        return v.unsqueeze(axis)

    dcx = d[..., 0] * exp(pw) + exp(pcx)
    dcy = d[..., 1] * exp(ph) + exp(pcy)
    dw = torch.exp(d[..., 2]) * exp(pw)
    dh = torch.exp(d[..., 3]) * exp(ph)
    return torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                        dcx + dw * 0.5 - norm, dcy + dh * 0.5 - norm], dim=-1)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes (from the shapes alone, on the host): (boxes,
    variances), each (H, W, priors, 4), on ``input``'s device."""
    fh, fw = int(input.shape[2]), int(input.shape[3])
    ih, iw = int(image.shape[2]), int(image.shape[3])
    step_h = steps[1] or ih / fh
    step_w = steps[0] or iw / fw
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    boxes = []
    for h in range(fh):
        for w in range(fw):
            cx = (w + offset) * step_w
            cy = (h + offset) * step_h
            cell = []
            for k, ms in enumerate(min_sizes):
                if min_max_aspect_ratios_order:
                    cell.append((cx, cy, ms, ms))
                    if max_sizes:
                        sz = float(np.sqrt(ms * max_sizes[k]))
                        cell.append((cx, cy, sz, sz))
                    for ar in ars:
                        if abs(ar - 1.0) < 1e-6:
                            continue
                        cell.append((cx, cy, ms * np.sqrt(ar),
                                     ms / np.sqrt(ar)))
                else:
                    for ar in ars:
                        cell.append((cx, cy, ms * np.sqrt(ar),
                                     ms / np.sqrt(ar)))
                    if max_sizes:
                        sz = float(np.sqrt(ms * max_sizes[k]))
                        cell.append((cx, cy, sz, sz))
            boxes.extend(cell)
    arr = np.asarray(boxes, np.float32).reshape(fh, fw, -1, 4)
    out = np.stack([(arr[..., 0] - arr[..., 2] / 2) / iw,
                    (arr[..., 1] - arr[..., 3] / 2) / ih,
                    (arr[..., 0] + arr[..., 2] / 2) / iw,
                    (arr[..., 1] + arr[..., 3] / 2) / ih], axis=-1)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32), out.shape).copy()
    dev = _device_of(input)
    return _out(out, dev), _out(var, dev)


def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             clip_bbox=True, name=None, scale_x_y=1.0, iou_aware=False,
             iou_aware_factor=0.5):
    """Decode a YOLOv3 head's output (N, anchors·(5 + classes), H, W) to
    (boxes (N, anchors·H·W, 4), scores (N, anchors·H·W, classes))."""
    xv, imgs = x, img_size
    n, _, h, w = xv.shape
    na = len(anchors) // 2
    an = torch.as_tensor(np.asarray(anchors, np.float32).reshape(na, 2),
                         device=xv.device)
    sig = torch.sigmoid
    ioup = None
    if iou_aware:
        # the first na channels are the IoU maps, the rest the regular head
        ioup, xv = xv[:, :na], xv[:, na:]
    xv = xv.reshape(n, na, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=xv.dtype, device=xv.device)[None, :]
    gy = torch.arange(h, dtype=xv.dtype, device=xv.device)[:, None]
    bx = (sig(xv[:, :, 0]) * scale_x_y - 0.5 * (scale_x_y - 1.0) + gx) / w
    by = (sig(xv[:, :, 1]) * scale_x_y - 0.5 * (scale_x_y - 1.0) + gy) / h
    bw = torch.exp(xv[:, :, 2]) * an[None, :, 0, None, None] / (
        w * downsample_ratio)
    bh = torch.exp(xv[:, :, 3]) * an[None, :, 1, None, None] / (
        h * downsample_ratio)
    conf = sig(xv[:, :, 4])
    if iou_aware:
        conf = conf ** (1.0 - iou_aware_factor) * sig(ioup) ** \
            iou_aware_factor
    probs = sig(xv[:, :, 5:]) * conf[:, :, None]
    conf_mask = (conf > conf_thresh).to(xv.dtype)
    imgh = imgs[:, 0].to(xv.dtype)[:, None, None, None]
    imgw = imgs[:, 1].to(xv.dtype)[:, None, None, None]
    x1 = (bx - bw / 2) * imgw
    y1 = (by - bh / 2) * imgh
    x2 = (bx + bw / 2) * imgw
    y2 = (by + bh / 2) * imgh
    if clip_bbox:
        x1 = torch.clamp(torch.clamp(x1, min=0), max=imgw - 1)
        y1 = torch.clamp(torch.clamp(y1, min=0), max=imgh - 1)
        x2 = torch.clamp(torch.clamp(x2, min=0), max=imgw - 1)
        y2 = torch.clamp(torch.clamp(y2, min=0), max=imgh - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1) * conf_mask[..., None]
    boxes = boxes.permute(0, 1, 3, 4, 2).reshape(n, -1, 4)
    scores = (probs * conf_mask[:, :, None]).permute(0, 1, 3, 4, 2)
    scores = scores.reshape(n, -1, class_num)
    return boxes, scores


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """Route RoIs to FPN levels by scale, on the host: (the RoIs of each
    level, the order that restores the input's, each level's RoIs an
    image or None)."""
    rois = host_numpy(fpn_rois)
    dev = _device_of(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    scale = np.sqrt(np.maximum((rois[:, 2] - rois[:, 0] + off) *
                               (rois[:, 3] - rois[:, 1] + off), 0))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    # each RoI's image (for the per-image counts per level)
    if rois_num is not None:
        rn = host_numpy(rois_num).astype(np.int64)
        img_ids = np.repeat(np.arange(len(rn)), rn)
    else:
        rn, img_ids = None, None
    outs, idxs, res_num = [], [], []
    for l in range(min_level, max_level + 1):
        sel = np.nonzero(lvl == l)[0]
        outs.append(_out(rois[sel], dev))
        idxs.append(sel)
        if rn is not None:
            per_img = np.bincount(img_ids[sel], minlength=len(rn)).astype(
                np.int32)
            res_num.append(_out(per_img, dev))
    order = np.concatenate(idxs) if idxs else np.zeros(0, np.int64)
    restore = _out(np.argsort(order).astype(np.int32), dev)
    return outs, restore, (res_num if rn is not None else None)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False, name=None):
    """RPN proposals on the host: decode, clip, filter, NMS."""
    sc = host_numpy(scores)          # [N, A, H, W]
    bd = host_numpy(bbox_deltas)     # [N, 4A, H, W]
    im = host_numpy(img_size)        # [N, 2]
    an = host_numpy(anchors).reshape(-1, 4)
    va = host_numpy(variances).reshape(-1, 4)
    n, a, h, w = sc.shape
    off = 1.0 if pixel_offset else 0.0
    all_rois, all_num = [], []
    for i in range(n):
        s = sc[i].transpose(1, 2, 0).reshape(-1)
        d = bd[i].reshape(a, 4, h, w).transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s, d, anc, v = s[order], d[order], an[order], va[order]
        aw = anc[:, 2] - anc[:, 0] + off
        ah = anc[:, 3] - anc[:, 1] + off
        acx = anc[:, 0] + aw * 0.5
        acy = anc[:, 1] + ah * 0.5
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        bw = np.exp(np.minimum(v[:, 2] * d[:, 2], np.log(1000. / 16))) * aw
        bh = np.exp(np.minimum(v[:, 3] * d[:, 3], np.log(1000. / 16))) * ah
        boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2 - off,
                          cy + bh / 2 - off], 1)
        ih, iw = im[i, 0], im[i, 1]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, iw - off)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ih - off)
        keep = np.nonzero((boxes[:, 2] - boxes[:, 0] + off >= min_size) &
                          (boxes[:, 3] - boxes[:, 1] + off >= min_size))[0]
        boxes, s = boxes[keep], s[keep]
        if len(boxes):
            iou = _np_iou_matrix(boxes)
            order2 = np.argsort(-s)
            sup = np.zeros(len(boxes), bool)
            kept = []
            for j in order2:
                if sup[j]:
                    continue
                kept.append(j)
                if len(kept) >= post_nms_top_n:
                    break
                sup |= iou[j] > nms_thresh
                sup[j] = True
            boxes, s = boxes[kept], s[kept]
        all_rois.append(boxes)
        all_num.append(len(boxes))
    dev = _device_of(scores)
    rois = _out(np.concatenate(all_rois, 0) if all_rois else
                np.zeros((0, 4), np.float32), dev)
    nums = _out(np.asarray(all_num, np.int32), dev)
    if return_rois_num:
        return rois, nums
    return rois


# ---------------------------------------------------------------- RoI family

def _pair(output_size):
    return (tuple(output_size) if isinstance(output_size, (list, tuple))
            else (output_size, output_size))


def _roi_batch_ids(boxes_num, n_rois, device):
    """Each RoI's image: ``boxes_num`` read on the host (RoIs of image 0
    first), every RoI on image 0 without it."""
    if boxes_num is None:
        return torch.zeros(n_rois, dtype=torch.long, device=device)
    bn = host_numpy(boxes_num).astype(np.int64)
    return torch.from_numpy(np.repeat(np.arange(len(bn)), bn)).to(device)


def _roi_chunks(n_rois, per_roi):
    """Slices of the RoIs that each materialise at most ``_CHUNK_ELEMS``
    elements, at ``per_roi`` a RoI."""
    step = max(1, _CHUNK_ELEMS // max(per_roi, 1))
    return [slice(i, min(i + step, n_rois)) for i in range(0, n_rois, step)]


def roi_align(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign (R, C, oh, ow) as the JAX package computes it: one
    bilinear sample a bin, at its centre (``sampling_ratio`` is taken and
    ignored)."""
    oh, ow = _pair(output_size)
    feat, rois = x, boxes
    dev = feat.device
    b = _roi_batch_ids(boxes_num, int(rois.shape[0]), dev)
    _, _, H, W = feat.shape
    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * spatial_scale - offset
    y1 = rois[:, 1] * spatial_scale - offset
    x2 = rois[:, 2] * spatial_scale - offset
    y2 = rois[:, 3] * spatial_scale - offset
    rh = torch.clamp(y2 - y1, min=1e-6) / oh
    rw = torch.clamp(x2 - x1, min=1e-6) / ow
    ys = y1[:, None] + (torch.arange(oh, device=dev) + 0.5) * rh[:, None]
    xs = x1[:, None] + (torch.arange(ow, device=dev) + 0.5) * rw[:, None]
    y0 = torch.clamp(torch.floor(ys).to(torch.int32), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int32), 0, W - 1)
    y1i = torch.clamp(y0 + 1, 0, H - 1)
    x1i = torch.clamp(x0 + 1, 0, W - 1)
    wy = torch.clamp(ys - y0, 0, 1)
    wx = torch.clamp(xs - x0, 0, 1)
    bb = b[:, None, None]

    def tap(yi, xi):
        # (R, oh, ow, C) -> (R, C, oh, ow)
        return feat[bb, :, yi.long()[:, :, None],
                    xi.long()[:, None, :]].permute(0, 3, 1, 2)

    v00, v01 = tap(y0, x0), tap(y0, x1i)
    v10, v11 = tap(y1i, x0), tap(y1i, x1i)
    wx_, wy_ = wx[:, None, None, :], wy[:, None, :, None]
    top = v00 * (1 - wx_) + v01 * wx_
    bot = v10 * (1 - wx_) + v11 * wx_
    return top * (1 - wy_) + bot * wy_


def roi_pool(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
             name=None):
    """RoIPool (R, C, oh, ow): the max over each bin of the box rounded to
    whole cells (0 for an empty bin). Each RoI's rows and each bin's
    columns are gathered (as many as the widest reaches: a host read of
    two sizes), the max taken over the bin's columns, then its rows (a
    rectangle's max; a tie splits the gradient evenly, as JAX's max
    does)."""
    oh, ow = _pair(output_size)
    feat, rois = x, boxes
    dev = feat.device
    b = _roi_batch_ids(boxes_num, int(rois.shape[0]), dev)
    _, C, H, W = feat.shape
    x1 = torch.round(rois[:, 0] * spatial_scale).to(torch.int32)
    y1 = torch.round(rois[:, 1] * spatial_scale).to(torch.int32)
    x2 = torch.round(rois[:, 2] * spatial_scale).to(torch.int32)
    y2 = torch.round(rois[:, 3] * spatial_scale).to(torch.int32)
    # the bin edges in float64: floor / ceil of a multiple of a ratio of
    # integers fall where exact arithmetic puts them (in fp32 a product
    # that should be whole can land a rounding above it)
    rh = torch.clamp(y2 - y1 + 1, min=1).double() / oh
    rw = torch.clamp(x2 - x1 + 1, min=1).double() / ow
    ai = torch.arange(oh, device=dev, dtype=torch.float64)
    aj = torch.arange(ow, device=dev, dtype=torch.float64)

    def edges(lo, r, a, n):
        start = torch.clamp(lo[:, None] + torch.floor(a * r[:, None]).long(),
                            0, n)
        end = torch.clamp(lo[:, None] + torch.ceil((a + 1) * r[:, None])
                          .long(), 0, n)
        return start, end

    hstart, hend = edges(y1.long(), rh, ai, H)              # (R, oh)
    wstart, wend = edges(x1.long(), rw, aj, W)              # (R, ow)
    R = int(rois.shape[0])
    # each RoI's rows from its first bin's start; each bin's columns
    KH = max(int((hend[:, -1] - hstart[:, 0]).max()), 1) if R else 1
    KW = max(int((wend - wstart).max()), 1) if R else 1
    rows = hstart[:, :1] + torch.arange(KH, device=dev)     # (R, KH)
    cols = wstart[:, :, None] + torch.arange(KW, device=dev)  # (R, ow, KW)
    rmask = (rows[:, None] >= hstart[:, :, None]) & \
        (rows[:, None] < hend[:, :, None])                  # (R, oh, KH)
    cmask = cols < wend[:, :, None]                         # (R, ow, KW)
    rows, cols = rows.clamp(max=H - 1), cols.clamp(max=W - 1)
    neg = torch.tensor(float("-inf"), dtype=feat.dtype, device=dev)
    outs = []
    for sl in _roi_chunks(R, KH * ow * KW * C):
        g = feat[b[sl, None, None, None], :, rows[sl, :, None, None],
                 cols[sl, None]]                     # (r, KH, ow, KW, C)
        g = torch.where(cmask[sl][:, None, :, :, None], g, neg).amax(3)
        g = torch.where(rmask[sl][:, :, :, None, None], g[:, None],
                        neg).amax(2)                        # (r, oh, ow, C)
        outs.append(g.permute(0, 3, 1, 2))
    out = torch.cat(outs) if outs else feat.new_zeros(0, C, oh, ow)
    empty = ~(rmask.any(-1)[:, :, None] & cmask.any(-1)[:, None, :])
    return torch.where(empty[:, None], torch.zeros((), dtype=feat.dtype,
                                                   device=dev), out)


def psroi_pool(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling (R-FCN): input channels C_out · oh ·
    ow; bin (i, j) averages its own channel slice over the bin."""
    oh, ow = _pair(output_size)
    feat, rois = x, boxes
    dev = feat.device
    b = _roi_batch_ids(boxes_num, int(rois.shape[0]), dev)
    _, C, H, W = feat.shape
    c_out = C // (oh * ow)
    x1 = rois[:, 0] * spatial_scale
    y1 = rois[:, 1] * spatial_scale
    x2 = rois[:, 2] * spatial_scale
    y2 = rois[:, 3] * spatial_scale
    rh = torch.clamp(y2 - y1, min=0.1) / oh
    rw = torch.clamp(x2 - x1, min=0.1) / ow
    ai = torch.arange(oh, device=dev)
    aj = torch.arange(ow, device=dev)
    hstart = torch.floor(y1[:, None] + ai * rh[:, None])
    hend = torch.ceil(y1[:, None] + (ai + 1) * rh[:, None])
    wstart = torch.floor(x1[:, None] + aj * rw[:, None])
    wend = torch.ceil(x1[:, None] + (aj + 1) * rw[:, None])
    hs = torch.arange(H, dtype=feat.dtype, device=dev)
    ws = torch.arange(W, dtype=feat.dtype, device=dev)
    hm = ((hs >= hstart[:, :, None]) & (hs < hend[:, :, None])).to(
        feat.dtype)                                       # (R, oh, H)
    wm = ((ws >= wstart[:, :, None]) & (ws < wend[:, :, None])).to(
        feat.dtype)                                       # (R, ow, W)
    outs = []
    for sl in _roi_chunks(int(rois.shape[0]), C * H * W):
        fm = feat[b[sl]].reshape(-1, c_out, oh, ow, H, W)
        outs.append(torch.einsum("rcijhw,rih,rjw->rcij", fm, hm[sl],
                                 wm[sl]))
    s = torch.cat(outs) if outs else feat.new_zeros(0, c_out, oh, ow)
    cnt = torch.clamp(hm.sum(-1)[:, :, None] * wm.sum(-1)[:, None, :],
                      min=1.0)
    return s / cnt[:, None]


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self._output_size,
                         self._spatial_scale, aligned=aligned)


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._output_size,
                        self._spatial_scale)


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self._output_size,
                          self._spatial_scale)


# ----------------------------------------------------------- deformable conv

def _triple(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 / v2 (with ``mask``) as the JAX package
    computes it: every tap bilinearly sampled at its offset position (a
    corner outside the map reads 0), then one product with the weight,
    accumulated in fp32.

    x: [N, Cin, H, W]; offset: [N, 2·dg·kh·kw, Ho, Wo] (y, x a tap);
    mask: [N, dg·kh·kw, Ho, Wo]; weight: [Cout, Cin/groups, kh, kw]."""
    s, p, d = _triple(stride), _triple(padding), _triple(dilation)
    N, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    Ho = (H + 2 * p[0] - (d[0] * (kh - 1) + 1)) // s[0] + 1
    Wo = (W + 2 * p[1] - (d[1] * (kw - 1) + 1)) // s[1] + 1
    K = kh * kw
    dg = deformable_groups
    dev = x.device
    # the base sampling grid [K, Ho, Wo]
    base_y = (torch.arange(Ho, device=dev) * s[0] - p[0])[None, :, None] + \
        (torch.arange(kh, device=dev) * d[0]).repeat_interleave(kw)[
            :, None, None]
    base_x = (torch.arange(Wo, device=dev) * s[1] - p[1])[None, None, :] + \
        (torch.arange(kw, device=dev) * d[1]).repeat(kh)[:, None, None]
    off = offset.reshape(N, dg, K, 2, Ho, Wo)
    sy = base_y[None, None].to(x.dtype) + off[:, :, :, 0]   # (N, dg, K, Ho, Wo)
    sx = base_x[None, None].to(x.dtype) + off[:, :, :, 1]
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = sy - y0
    wx = sx - x0
    y0i = y0.to(torch.int32)
    x0i = x0.to(torch.int32)
    Cg = Cin // dg
    fm = x.reshape(N, dg, Cg, H * W)
    L = K * Ho * Wo

    def tap(yi, xi):
        # (N, dg, Cg, K, Ho, Wo): the map at (yi, xi), 0 outside it
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (torch.clamp(yi, 0, H - 1) * W
               + torch.clamp(xi, 0, W - 1)).long().reshape(N, dg, 1, L)
        v = torch.gather(fm, 3, idx.expand(N, dg, Cg, L)).reshape(
            N, dg, Cg, K, Ho, Wo)
        return v * valid[:, :, None].to(x.dtype)

    cols = (tap(y0i, x0i) * ((1 - wy) * (1 - wx))[:, :, None] +
            tap(y0i, x0i + 1) * ((1 - wy) * wx)[:, :, None] +
            tap(y0i + 1, x0i) * (wy * (1 - wx))[:, :, None] +
            tap(y0i + 1, x0i + 1) * (wy * wx)[:, :, None])
    cols = cols.reshape(N, Cin, K, Ho, Wo)
    if mask is not None:
        m = mask.reshape(N, dg, 1, K, Ho, Wo).expand(N, dg, Cg, K, Ho, Wo)
        cols = cols * m.reshape(N, Cin, K, Ho, Wo)
    cols = cols.reshape(N, groups, (Cin // groups) * K, Ho * Wo)
    wg = weight.reshape(groups, Cout // groups, (Cin // groups) * K)
    out = torch.matmul(wg.float(), cols.float()).to(x.dtype)
    out = out.reshape(N, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


class DeformConv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None,
                 place=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, place=place,
                         generator=generator)
        ks = _triple(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        fan_in = in_channels * ks[0] * ks[1] // groups
        k = float(np.sqrt(1.0 / fan_in))
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *ks],
            default_initializer=Uniform(-k, k))
        self.bias = (None if bias_attr is False else
                     self.create_parameter([out_channels], is_bias=True,
                                           default_initializer=Uniform(-k, k)))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, self._stride,
                             self._padding, self._dilation,
                             self._deformable_groups, self._groups, mask)


def read_file(filename, name=None):
    """The file's bytes as a 1-D uint8 CPU tensor."""
    with open(filename, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return torch.from_numpy(data.copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode JPEG bytes (a 1-D uint8 tensor) to a (C, H, W) uint8 image
    on ``x``'s device, through Pillow on the host (imported here: a
    machine without it can run everything else)."""
    import io

    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("decode_jpeg needs Pillow") from e

    raw = bytes(host_numpy(x).astype(np.uint8))
    img = Image.open(io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None]  # (1, H, W)
    else:
        arr = arr.transpose(2, 0, 1)  # (C, H, W)
    return _out(arr, _device_of(x))


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 training loss, (N,): per sample the sum of the box terms
    (sigmoid-CE on x, y and L1 on w, h, weighted by 2 - w·h), objectness
    (sigmoid-CE; a prediction overlapping a ground truth above
    ``ignore_thresh`` is not counted as background) and classes
    (sigmoid-CE, optionally label-smoothed).

    x: [N, S·(5+C), H, W]; gt_box: [N, B, 4] (cx, cy, w, h, normalized);
    gt_label: [N, B] int."""
    xv = x
    dev = xv.device
    gb = gt_box.to(torch.float32)
    gl = gt_label.to(torch.int32)
    gs = (gt_score.to(torch.float32) if gt_score is not None
          else torch.ones(gl.shape, dtype=torch.float32, device=dev))
    N, _, H, W = xv.shape
    S = len(anchor_mask)
    C = int(class_num)
    an_np = np.asarray(anchors, np.float32).reshape(-1, 2)  # every (w, h)
    an = torch.from_numpy(an_np).to(dev)
    mask_an = torch.from_numpy(an_np[np.asarray(anchor_mask)]).to(dev)
    in_h, in_w = H * downsample_ratio, W * downsample_ratio

    p = xv.reshape(N, S, 5 + C, H, W).to(torch.float32)
    tx, ty, tw, th = p[:, :, 0], p[:, :, 1], p[:, :, 2], p[:, :, 3]
    tobj, tcls = p[:, :, 4], p[:, :, 5:]

    # ---- the targets, over the B ground-truth slots
    B = gb.shape[1]
    gx = gb[..., 0] * W    # [N, B] in grid units
    gy = gb[..., 1] * H
    gw = gb[..., 2] * in_w  # pixels
    gh = gb[..., 3] * in_h
    valid = (gb[..., 2] > 0) & (gb[..., 3] > 0)
    # each ground truth's best anchor over ALL anchors (shape-only IoU)
    inter = (torch.minimum(gw[..., None], an[:, 0]) *
             torch.minimum(gh[..., None], an[:, 1]))
    union = gw[..., None] * gh[..., None] + an[:, 0] * an[:, 1] - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-9), -1)  # [N, B]

    f32 = dict(dtype=torch.float32, device=dev)
    obj_t = torch.zeros(N, S, H, W, **f32)
    obj_w = torch.zeros(N, S, H, W, **f32)  # per-cell gt_score weight
    xy_t = torch.zeros(N, S, 2, H, W, **f32)
    wh_t = torch.zeros(N, S, 2, H, W, **f32)
    box_w = torch.zeros(N, S, H, W, **f32)
    cls_t = torch.zeros(N, S, C, H, W, **f32)
    batch = torch.arange(N, device=dev)
    one, zero = torch.ones((), **f32), torch.zeros((), **f32)
    # one cell a batch element per assignment: no index repeats in a write
    for b in range(B):
        gi = torch.clamp(gx[:, b].to(torch.int32), 0, W - 1).long()
        gj = torch.clamp(gy[:, b].to(torch.int32), 0, H - 1).long()
        for s, a_idx in enumerate(np.asarray(anchor_mask).tolist()):
            sel = valid[:, b] & (best[:, b] == a_idx)
            w8 = torch.where(sel, gs[:, b], zero)
            at = (batch, s, gj, gi)
            obj_t[at] = torch.maximum(obj_t[at], torch.where(sel, one, zero))
            obj_w[at] = torch.maximum(obj_w[at], w8)
            sxy = torch.stack([gx[:, b] - gi, gy[:, b] - gj], -1)  # in (0,1)
            swh = torch.stack(
                [torch.log(torch.clamp(gw[:, b] / an[a_idx, 0], min=1e-9)),
                 torch.log(torch.clamp(gh[:, b] / an[a_idx, 1], min=1e-9))],
                -1)
            for d in range(2):
                ad = (batch, s, d, gj, gi)
                xy_t[ad] = torch.where(sel, sxy[:, d], xy_t[ad])
                wh_t[ad] = torch.where(sel, swh[:, d], wh_t[ad])
            scale = 2.0 - gb[:, b, 2] * gb[:, b, 3]
            box_w[at] = torch.where(sel, scale * gs[:, b], box_w[at])
            lbl = torch.clamp(gl[:, b], 0, C - 1).long()
            al = (batch, s, lbl, gj, gi)
            cls_t[al] = torch.where(sel, one, cls_t[al])

    # ---- the ignore mask: a predicted box overlapping any ground truth
    # above the threshold is not penalised as background
    grid_x = torch.arange(W, **f32)
    grid_y = torch.arange(H, **f32)[:, None]
    px = (torch.sigmoid(tx) * scale_x_y - (scale_x_y - 1) / 2 + grid_x) / W
    py = (torch.sigmoid(ty) * scale_x_y - (scale_x_y - 1) / 2 + grid_y) / H
    pw = torch.exp(torch.clamp(tw, -10, 10)) * mask_an[:, 0][:, None, None] \
        / in_w
    ph = torch.exp(torch.clamp(th, -10, 10)) * mask_an[:, 1][:, None, None] \
        / in_h

    def iou_cell(px, py, pw, ph, qx, qy, qw, qh):
        x1 = torch.maximum(px - pw / 2, qx - qw / 2)
        x2 = torch.minimum(px + pw / 2, qx + qw / 2)
        y1 = torch.maximum(py - ph / 2, qy - qh / 2)
        y2 = torch.minimum(py + ph / 2, qy + qh / 2)
        inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
        return inter / torch.clamp(pw * ph + qw * qh - inter, min=1e-9)

    best_iou = torch.zeros(N, S, H, W, **f32)
    for b in range(B):
        i = iou_cell(px, py, pw, ph,
                     gb[:, b, 0][:, None, None, None],
                     gb[:, b, 1][:, None, None, None],
                     gb[:, b, 2][:, None, None, None],
                     gb[:, b, 3][:, None, None, None])
        best_iou = torch.maximum(best_iou, torch.where(
            valid[:, b][:, None, None, None], i, zero))
    noobj_mask = (best_iou < ignore_thresh).to(torch.float32)

    def bce(logit, target):
        return torch.clamp(logit, min=0) - logit * target + \
            torch.log1p(torch.exp(-torch.abs(logit)))

    axes = (1, 2, 3)
    loss_xy = torch.sum(box_w[:, :, None] * bce(
        torch.stack([tx, ty], 2), xy_t), (1, 2, 3, 4))
    loss_wh = torch.sum(box_w[:, :, None] * torch.abs(
        torch.stack([tw, th], 2) - wh_t) * obj_t[:, :, None], (1, 2, 3, 4))
    loss_obj = torch.sum(obj_w * bce(tobj, obj_t) * obj_t, axes) + \
        torch.sum(noobj_mask * bce(tobj, obj_t) * (1 - obj_t), axes)
    smooth = 1.0 / max(C, 1) if use_label_smooth else 0.0
    cls_target = cls_t * (1 - smooth) + smooth / max(C, 1)
    loss_cls = torch.sum(obj_t[:, :, None] * bce(tcls, cls_target),
                         (1, 2, 3, 4))
    return loss_xy + loss_wh + loss_obj + loss_cls
