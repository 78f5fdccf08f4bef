"""Evaluation metrics + mask paste-back (host-side NumPy); the port's own
copy of `lang2seg_tpu/utils/metrics.py`.

The reference-exact chain (`bytescale`, `scipy_imresize`,
`recover_masks_ref`) resizes through Pillow in the JAX package. The port
keeps its own NumPy copies of Pillow's 'L'-mode resizes instead
(`pil_resize_nearest`, `pil_resize_bilinear`, from Pillow's
`libImaging/Geometry.c` and `Resample.c`), bit for bit, so that it needs
no Pillow.

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

import math
from typing import Dict

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


def _pil_nearest_taps(n_out: int, n_in: int) -> np.ndarray:
    """Source index of each output pixel along one axis, as Pillow's
    `ImagingScaleAffine` walks it: a double position that starts at half
    a step and adds the step (n_in / n_out) once a pixel, truncated; -1
    where it leaves the source (the pixel is then 0)."""
    step = float(n_in) / n_out
    pos = np.add.accumulate(np.concatenate(
        [[step * 0.5], np.full(n_out - 1, step)]))
    idx = np.where(pos < 0.0, -1, pos.astype(np.int64))
    return np.where(idx < n_in, idx, -1)


def pil_resize_nearest(data: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Pillow's `Image.resize((ow, oh), NEAREST)` of a 2-D uint8 ('L')
    image: the accumulated source positions of `_pil_nearest_taps`, which
    differ from exact-rational nearest on boundary pixels."""
    h, w = data.shape
    ys, xs = _pil_nearest_taps(oh, h), _pil_nearest_taps(ow, w)
    out = data[np.ix_(np.maximum(ys, 0), np.maximum(xs, 0))]
    out[ys < 0] = 0
    out[:, xs < 0] = 0
    return out


_PRECISION_BITS = 32 - 8 - 2            # Pillow's 8-bit fixed point


def _pil_bilinear_coeffs(n_in: int, n_out: int):
    """(first source index, fixed-point weights (n_out, ksize) int64, 0
    past each output's last tap) of Pillow's `precompute_coeffs` +
    `normalize_coeffs_8bpc` for the bilinear filter (support 1, widened
    by the scale on a downscale), in its double arithmetic and its order
    of operations."""
    scale = float(n_in) / n_out
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(n_out, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), n_in) - xmin
    k = np.zeros((n_out, ksize), np.float64)
    ww = np.zeros(n_out, np.float64)
    for x in range(ksize):                       # the C loop's sum order
        arg = np.abs(((x + xmin).astype(np.float64) - center + 0.5) * ss)
        wx = np.where((x < xmax) & (arg < 1.0), 1.0 - arg, 0.0)
        k[:, x] = wx
        ww = ww + wx
    k = np.where(ww[:, None] != 0.0,
                 k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    scaled = k * (1 << _PRECISION_BITS)
    fixed = np.where(k < 0, -0.5 + scaled, 0.5 + scaled)
    return xmin, np.trunc(fixed).astype(np.int64)


def _pil_bilinear_pass(data: np.ndarray, n_out: int, axis: int
                       ) -> np.ndarray:
    """One pass of Pillow's `ImagingResample{Horizontal,Vertical}_8bpc`
    along `axis` of a uint8 image: integer sums of fixed-point taps from
    a rounding half, shifted back and clipped to uint8."""
    x = np.moveaxis(data, axis, -1).astype(np.int64)
    xmin, k = _pil_bilinear_coeffs(x.shape[-1], n_out)
    acc = np.full(x.shape[:-1] + (n_out,), 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for t in range(k.shape[1]):
        acc += x[..., np.minimum(xmin + t, x.shape[-1] - 1)] * k[:, t]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def pil_resize_bilinear(data: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Pillow's `Image.resize((ow, oh), BILINEAR)` of a 2-D uint8 ('L')
    image: two separable passes, the width first, each only where that
    extent changes, through a uint8 intermediate."""
    out = data
    if ow != data.shape[1]:
        out = _pil_bilinear_pass(out, ow, 1)
    if oh != data.shape[0]:
        out = _pil_bilinear_pass(out, oh, 0)
    return out.copy() if out is data else out


def bytescale(data: np.ndarray) -> np.ndarray:
    """scipy.misc.bytescale semantics: uint8 passes through untouched;
    any other dtype is rescaled by ITS OWN min/max to [0, 255] and
    rounded half-up to uint8. Inside the reference's mask paste-back
    (scipy imresize -> toimage, utils/mask_utils.py:63-67) this acts as
    an accidental per-mask adaptive threshold: a mask whose
    probabilities span e.g. [0.3, 0.6] is stretched to [0, 255] before
    the fixed 122 cut."""
    if data.dtype == np.uint8:
        return data
    cmin = float(data.min())
    cmax = float(data.max())
    cscale = cmax - cmin
    if cscale == 0.0:
        cscale = 1.0
    scaled = (data.astype(np.float64) - cmin) * (255.0 / cscale)
    return (np.clip(scaled, 0, 255) + 0.5).astype(np.uint8)


def scipy_imresize(arr: np.ndarray, size, interp: str = "bilinear"
                   ) -> np.ndarray:
    """Reference-era scipy.misc.imresize: bytescale to uint8, then
    Pillow's 'L'-mode resize (here its NumPy copies) to size = (oh, ow);
    returns uint8."""
    data = bytescale(np.ascontiguousarray(arr))
    resize = {"nearest": pil_resize_nearest,
              "bilinear": pil_resize_bilinear}[interp]
    return resize(data, int(size[0]), int(size[1]))


def recover_masks_ref(mask_probs: np.ndarray, boxes: np.ndarray,
                      ih: int, iw: int) -> np.ndarray:
    """REFERENCE-EXACT paste-back (utils/mask_utils.py:43-72): mask
    probabilities x255 as float -> scipy imresize 'bilinear' (bytescale
    + Pillow) to the box extent -> uint8 painted into a zero uint8
    canvas. The caller applies the reference's `> 122.` cut
    (model/test.py:334). Returns (N, ih, iw) uint8 in [0, 255]."""
    n = mask_probs.shape[0]
    out = np.zeros((n, ih, iw), np.uint8)
    b = boxes.astype(np.float64).copy()
    b[:, 0::2] = np.clip(b[:, 0::2], 0, iw - 1)
    b[:, 1::2] = np.clip(b[:, 1::2], 0, ih - 1)
    for i in range(n):
        m = mask_probs[i].astype(np.float32) * 255.0
        h = int(b[i, 3] - b[i, 1] + 1)
        w = int(b[i, 2] - b[i, 0] + 1)
        x, y = int(b[i, 0]), int(b[i, 1])
        out[i, y:y + h, x:x + w] = scipy_imresize(m, (h, w), "bilinear")
    return out


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
