"""Box math with the reference's legacy "+1" pixel convention:
width = x2 - x1 + 1 (reference `mask-faster-rcnn/lib/model/bbox_transform.py`
and `lib/utils/bbox.py`). Counterpart of `lang2seg_tpu/ops/boxes.py`,
with the same operation order so f32 results agree bit for bit; every
function also takes leading batch dimensions.
"""

from __future__ import annotations

import torch


def encode_boxes(ex_rois: torch.Tensor, gt_rois: torch.Tensor) -> torch.Tensor:
    """Regression deltas mapping ex_rois -> gt_rois.

    ex_rois, gt_rois: (..., N, 4) [x1 y1 x2 y2]. Returns (..., N, 4)
    [dx dy dw dh]. Parity: reference bbox_transform (bbox_transform.py:14-33).
    Extents are clamped to 1e-6 so degenerate boxes encode to finite
    values (never binds for real boxes, whose extent is >= 1)."""
    ex_w = torch.clamp(ex_rois[..., 2] - ex_rois[..., 0] + 1.0, min=1e-6)
    ex_h = torch.clamp(ex_rois[..., 3] - ex_rois[..., 1] + 1.0, min=1e-6)
    ex_cx = ex_rois[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois[..., 1] + 0.5 * ex_h

    gt_w = torch.clamp(gt_rois[..., 2] - gt_rois[..., 0] + 1.0, min=1e-6)
    gt_h = torch.clamp(gt_rois[..., 3] - gt_rois[..., 1] + 1.0, min=1e-6)
    gt_cx = gt_rois[..., 0] + 0.5 * gt_w
    gt_cy = gt_rois[..., 1] + 0.5 * gt_h

    dx = (gt_cx - ex_cx) / ex_w
    dy = (gt_cy - ex_cy) / ex_h
    dw = torch.log(gt_w / ex_w)
    dh = torch.log(gt_h / ex_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply deltas to boxes.

    boxes: (..., N, 4); deltas: (..., N, 4) or (..., N, K*4) class-grouped.
    Returns the shape of deltas. Parity: bbox_transform_inv
    (bbox_transform.py:36-62). dw/dh are clamped at 10 so exp cannot
    overflow (e^10 ~ 22k px, beyond any image)."""
    out_shape = deltas.shape
    d = deltas.reshape(*deltas.shape[:-1], -1, 4)

    w = (boxes[..., 2] - boxes[..., 0] + 1.0)[..., None]
    h = (boxes[..., 3] - boxes[..., 1] + 1.0)[..., None]
    cx = boxes[..., 0][..., None] + 0.5 * w
    cy = boxes[..., 1][..., None] + 0.5 * h

    pcx = d[..., 0] * w + cx
    pcy = d[..., 1] * h + cy
    pw = torch.exp(torch.clamp(d[..., 2], max=10.0)) * w
    ph = torch.exp(torch.clamp(d[..., 3], max=10.0)) * h

    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                       pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
    return out.reshape(out_shape)


def clip_boxes(boxes: torch.Tensor, im_h, im_w) -> torch.Tensor:
    """Clip (..., 4) or (..., K*4) boxes to [0, w-1] x [0, h-1].
    im_h / im_w: Python numbers, or tensors broadcastable against the
    leading dimensions (with a trailing 1 for the box axis).
    Parity: clip_boxes (bbox_transform.py:65-81)."""
    out_shape = boxes.shape
    b = boxes.reshape(*boxes.shape[:-1], -1, 4)
    hi_x = im_w - 1.0
    hi_y = im_h - 1.0
    x1 = torch.clamp(torch.clamp(b[..., 0], min=0.0), max=hi_x)
    y1 = torch.clamp(torch.clamp(b[..., 1], min=0.0), max=hi_y)
    x2 = torch.clamp(torch.clamp(b[..., 2], min=0.0), max=hi_x)
    y2 = torch.clamp(torch.clamp(b[..., 3], min=0.0), max=hi_y)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(out_shape)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with the +1 area convention.

    a: (..., N, 4), b: (..., M, 4) -> (..., N, M). Parity: bbox_overlaps
    (lib/utils/bbox.py:4-31)."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)

    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = torch.clamp(rb - lt + 1.0, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union
