"""Evaluation metrics + mask paste-back (host-side NumPy); the port's own
copy of `lang2seg_tpu/utils/metrics.py` without the reference-exact
(scipy/PIL) paste-back, which is not ported yet.

Parity targets:
  * box IoU with the +1 convention (reference computeIoU_box,
    model/test.py:60-80)
  * mask paste-back: 14x14 probs -> bilinear to box size -> paint into
    (ih, iw) canvas -> binarize (reference recover_masks,
    utils/mask_utils.py:43-72, + threshold 122 at test.py:334). The
    reference routes through scipy imresize whose bytescale rescales the
    float mask to its own [min,max] before thresholding — an accidental
    adaptive threshold; we resize the [0,1] probabilities directly and
    threshold at 122/255 (tolerance-bounded deviation, SURVEY §7).
  * det acc / seg Prec@{0.5..0.9} / overall IoU accumulators
    (model/test.py:214-217, 299-307, 346-355).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def np_box_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two [x1 y1 x2 y2] boxes with the +1 area convention."""
    iw = min(a[2], b[2]) - max(a[0], b[0]) + 1
    ih = min(a[3], b[3]) - max(a[1], b[1]) + 1
    if iw <= 0 or ih <= 0:
        return 0.0
    inter = iw * ih
    ua = ((a[2] - a[0] + 1) * (a[3] - a[1] + 1)
          + (b[2] - b[0] + 1) * (b[3] - b[1] + 1) - inter)
    return float(inter / ua)


def bilinear_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Half-pixel-centered bilinear resize (PIL/cv2 INTER_LINEAR
    semantics) of a 2-D float array."""
    h, w = img.shape
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def nearest_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Exact-rational PIL-NEAREST resize of a 2-D array."""
    h, w = img.shape
    ys = ((2 * np.arange(oh) + 1) * h) // (2 * oh)
    xs = ((2 * np.arange(ow) + 1) * w) // (2 * ow)
    return img[np.ix_(ys, xs)]


def recover_masks(mask_probs: np.ndarray, boxes: np.ndarray,
                  ih: int, iw: int) -> np.ndarray:
    """Paste SxS mask probabilities back into image canvases.

    mask_probs: (N, S, S) float in [0,1]; boxes: (N, 4) [xyxy] in the
    SAME coordinate frame as (ih, iw). Returns (N, ih, iw) float in [0,1].
    Box corners are int-truncated and clipped, box extent = x2-x1+1
    (mask_utils.py:43-72 semantics)."""
    n = mask_probs.shape[0]
    out = np.zeros((n, ih, iw), np.float32)
    b = boxes.copy()
    b[:, 0::2] = np.clip(b[:, 0::2], 0, iw - 1)
    b[:, 1::2] = np.clip(b[:, 1::2], 0, ih - 1)
    for i in range(n):
        x1, y1, x2, y2 = (int(b[i, 0]), int(b[i, 1]),
                          int(b[i, 2]), int(b[i, 3]))
        h, w = y2 - y1 + 1, x2 - x1 + 1
        resized = bilinear_resize(mask_probs[i].astype(np.float32), h, w)
        out[i, y1:y1 + h, x1:x1 + w] = resized
    return out


class SegEvalAccumulator:
    """det acc + segmentation Prec@X + overall IoU, accumulated per
    sentence (model/test.py:214-217,299-307,346-355)."""

    IOU_THRESHOLDS = (0.5, 0.6, 0.7, 0.8, 0.9)

    def __init__(self):
        self.det_correct = 0
        self.num_sent = 0
        self.cum_i = 0.0
        self.cum_u = 0.0
        self.seg_correct = np.zeros(len(self.IOU_THRESHOLDS), np.int64)
        self.seg_total = 0

    def add_detection(self, pred_box, gt_box):
        if np_box_iou(np.asarray(pred_box), np.asarray(gt_box)) >= 0.5:
            self.det_correct += 1
        self.num_sent += 1

    def add_segmentation(self, pred_mask: np.ndarray, gt_mask: np.ndarray):
        self.add_segmentation_iu(
            float(np.logical_and(pred_mask, gt_mask).sum()),
            float(np.logical_or(pred_mask, gt_mask).sum()))

    def add_segmentation_iu(self, i: float, u: float):
        """Accumulate from precomputed intersection/union pixel counts
        (the device-paste eval path reduces I/U on device)."""
        self.cum_i += i
        self.cum_u += u
        iou = i / u if u > 0 else 0.0
        for k, t in enumerate(self.IOU_THRESHOLDS):
            self.seg_correct[k] += int(iou >= t)
        self.seg_total += 1

    def summary(self) -> Dict[str, float]:
        out = {
            "det_acc": self.det_correct / max(self.num_sent, 1),
            "overall_iou": self.cum_i / max(self.cum_u, 1e-9),
        }
        for k, t in enumerate(self.IOU_THRESHOLDS):
            out[f"seg_prec@{t}"] = (self.seg_correct[k]
                                    / max(self.seg_total, 1))
        return out
