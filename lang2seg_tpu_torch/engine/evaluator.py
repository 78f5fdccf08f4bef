"""Referring-expression evaluation, one image per call.

Counterpart of `lang2seg_tpu/engine/evaluator.py::Evaluator.eval_image`
on its device-paste path (reference eval_split, `model/test.py:185-450`):
all sentences of an image run through one `test_forward`; per sentence
the per-class boxes are decoded in original-image coordinates and the
single global argmax over scores[:, 1:] is taken (`_select_fn`); the mask
branch runs on that box; the 14x14 probs are pasted back on fixed
(max_orig_h, max_orig_w) buffers, cut at 122/255 and scored against the
nearest-resized GT mask (`_paste_iou_fn`); the host accumulates det acc,
Prec@X and overall IoU (`utils/metrics.py::SegEvalAccumulator`). GT masks
travel raw, or bit-packed (np.packbits along the width) when the canvas
width is a multiple of 8.

Not ported yet (ROADMAP): the host paste-back for images beyond the
paste buffers, the reference-exact mode, the ref-deduped mask bank, the
extent-crop wire, staged uploads, multi-image and multi-device eval.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models.network import Lang2Seg, unpack_mask_bits
from ..ops.boxes import decode_boxes
from ..utils.metrics import SegEvalAccumulator


class Evaluator:
    def __init__(self, model: Lang2Seg, cfg: Config, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg

    @staticmethod
    def _extents(batch):
        """(scale, sh, sw, ih, iw) for one image batch: ih derives from the
        already-rounded sh (the JAX package's rounding order)."""
        scale = float(batch["im_scale"])
        sh = int(round(float(batch["im_hw"][0][0])))
        sw = int(round(float(batch["im_hw"][0][1])))
        ih = int(round(sh / scale))
        iw = int(round(sw / scale))
        return scale, sh, sw, ih, iw

    def _fits(self, ih: int, iw: int) -> bool:
        """Whether an original extent fits the device-paste buffers."""
        return (ih <= self.cfg.data.max_orig_h
                and iw <= self.cfg.data.max_orig_w)

    @staticmethod
    def _select_fn(rois, deltas, scores, valid, scale, ih, iw):
        """Batched argmax protocol over all S sentences (test.py:256-259):
        decode per-class boxes in original-image coords, mask padded rois,
        global argmax over scores[:, 1:], select that class's box.
        scale / ih / iw: f32 tensors on the rois' device."""
        s, r, _ = rois.shape
        num_classes = scores.shape[-1]
        pred = decode_boxes(rois / scale, deltas)           # (S, R, 4K)
        pk = pred.reshape(s, r, num_classes, 4)
        lim = torch.stack([iw, ih, iw, ih]) - 1.0
        pk = torch.minimum(torch.clamp(pk, min=0.0), lim)
        sc = torch.where(valid[..., None], scores,
                         torch.full_like(scores, -1.0))
        flat = sc[:, :, 1:].reshape(s, -1)
        idx = torch.argmax(flat, dim=1)
        r_idx = idx // (num_classes - 1)
        cls = idx % (num_classes - 1) + 1
        sel = pk[torch.arange(s, device=rois.device), r_idx, cls]   # (S, 4)
        return sel, cls.to(torch.int32)

    @staticmethod
    def _paste_iou_fn(mask_probs, boxes, gt_masks, sh: int, sw: int,
                      ih: int, iw: int, *, oh: int, ow: int,
                      packed: bool = False):
        """Device paste-back + IoU, batched over sentences.

        mask_probs (S, M, M) in [0, 1]; boxes (S, 4) xyxy in original
        image coords; gt_masks (S, Hc, Wc) uint8 canvas masks, or
        (S, Hc, Wc // 8) bit-packed MSB-first; sh / sw the scaled extent,
        ih / iw the original extent. Returns per-sentence (I, U) pixel
        counts over the (ih, iw) region."""
        s, m, _ = mask_probs.shape
        dev = mask_probs.device
        if packed:
            gt_masks = unpack_mask_bits(gt_masks)

        # int-truncated, clipped box corners (recover_masks semantics)
        x1 = torch.clamp(boxes[:, 0], 0.0, iw - 1.0).to(torch.int32)
        y1 = torch.clamp(boxes[:, 1], 0.0, ih - 1.0).to(torch.int32)
        x2 = torch.clamp(boxes[:, 2], 0.0, iw - 1.0).to(torch.int32)
        y2 = torch.clamp(boxes[:, 3], 0.0, ih - 1.0).to(torch.int32)
        bh = (y2 - y1 + 1).float()
        bw = (x2 - x1 + 1).float()

        def axis_weights(p0, extent, size):
            """(S, size, M) separable half-pixel bilinear weights of the
            box-resized mask along one axis; zero outside the box."""
            pos = torch.arange(size, dtype=torch.float32, device=dev)[None]
            p = pos - p0[:, None].float()                     # (S, size)
            src = (p + 0.5) * m / extent[:, None] - 0.5
            s0 = torch.clamp(torch.floor(src), 0, m - 1).long()
            s1 = torch.clamp(s0 + 1, max=m - 1)
            frac = torch.clamp(src - s0.float(), 0.0, 1.0)
            k = torch.arange(m, device=dev)[None, None, :]
            wmat = ((1.0 - frac)[..., None] * (k == s0[..., None])
                    + frac[..., None] * (k == s1[..., None]))
            inside = (p >= 0) & (p < extent[:, None])
            return wmat * inside[..., None]

        wy = axis_weights(y1, bh, oh)                         # (S, oh, M)
        wx = axis_weights(x1, bw, ow)                         # (S, ow, M)
        pasted = torch.bmm(torch.bmm(wy, mask_probs.float()),
                           wx.transpose(1, 2))                # (S, oh, ow)
        pred = pasted * 255.0 > 122.0

        # GT: crop the scaled extent, exact-rational nearest resize to
        # (ih, iw) as row / column gathers
        ys = (2 * torch.arange(oh, device=dev) + 1) * sh // (2 * max(ih, 1))
        xs = (2 * torch.arange(ow, device=dev) + 1) * sw // (2 * max(iw, 1))
        ys = torch.clamp(ys, 0, gt_masks.shape[1] - 1)
        xs = torch.clamp(xs, 0, gt_masks.shape[2] - 1)
        gt = gt_masks.index_select(1, ys).index_select(2, xs) > 0

        valid = ((torch.arange(oh, device=dev)[:, None] < ih)
                 & (torch.arange(ow, device=dev)[None, :] < iw))[None]
        inter = (pred & gt & valid).sum(dim=(1, 2))
        union = ((pred | gt) & valid).sum(dim=(1, 2))
        return inter.to(torch.int32), union.to(torch.int32)

    @torch.no_grad()
    def eval_image(self, batch: Dict[str, np.ndarray],
                   acc: SegEvalAccumulator,
                   sent_valid: Optional[np.ndarray] = None) -> None:
        """batch: images (1, H, W, 3), im_hw (1, 2), labels (S, T),
        gt_boxes (S, 5) scaled, gt_masks (S, Hc, Wc), im_scale scalar.
        sent_valid: (S,) bool mask for padded sentence slots."""
        m, d = self.cfg.model, self.cfg.data
        if not m.use_mask_head:
            raise NotImplementedError("detection-only eval is not ported")
        scale, sh, sw, ih, iw = self._extents(batch)
        if not self._fits(ih, iw):
            raise NotImplementedError(
                f"original extent {ih}x{iw} exceeds the paste buffers "
                f"{d.max_orig_h}x{d.max_orig_w}; host paste-back is not "
                f"ported")
        dev = self.device
        gm = np.asarray(batch["gt_masks"])
        packed = gm.shape[-1] % 8 == 0
        gm_op = np.packbits(gm > 0, axis=-1) if packed else gm

        def put(x, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.to(dev) if dtype is None else t.to(dev, dtype)

        out = self.model.test_forward({
            "images": put(batch["images"]),
            "im_hw": put(batch["im_hw"], torch.float32),
            "labels": put(batch["labels"])})
        f32 = dict(dtype=torch.float32, device=dev)
        scale_t = torch.tensor(scale, **f32)
        sel, cls = self._select_fn(
            out["rois"], out["bbox_pred"], out["cls_prob"], out["roi_valid"],
            scale_t, torch.tensor(float(ih), **f32),
            torch.tensor(float(iw), **f32))
        probs = self.model.predict_masks(
            out["gated_conv"], (sel * scale_t)[:, None, :], cls[:, None])[:, 0]
        inter, union = self._paste_iou_fn(
            probs, sel, put(gm_op), sh, sw, ih, iw,
            oh=d.max_orig_h, ow=d.max_orig_w, packed=packed)

        sel_np = sel.cpu().numpy()
        inter_np = inter.cpu().numpy()
        union_np = union.cpu().numpy()
        for i in range(sel_np.shape[0]):
            if sent_valid is not None and not sent_valid[i]:
                continue
            gt_box = np.asarray(batch["gt_boxes"][i, :4]) / scale
            acc.add_detection(sel_np[i], gt_box)
            acc.add_segmentation_iu(int(inter_np[i]), int(union_np[i]))
