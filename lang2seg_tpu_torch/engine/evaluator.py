"""Referring-expression evaluation.

Counterpart of `lang2seg_tpu/engine/evaluator.py::Evaluator` on one
device (reference eval_split, `model/test.py:185-450`): all sentences of
an image run through one `test_forward`; per sentence the per-class boxes
are decoded in original-image coordinates and the single global argmax
over scores[:, 1:] is taken (`_select_fn`); the mask branch runs on that
box; the host accumulates det acc, Prec@X and overall IoU
(`utils/metrics.py::SegEvalAccumulator`).

The 14x14 mask probabilities are pasted back in one of two places:
  * on the device (`device_paste`, the default): on fixed (max_orig_h,
    max_orig_w) buffers, cut at 122/255 and scored against the
    nearest-resized GT mask (`_paste_iou_fn`), only I / U counts coming
    back; GT masks travel per sentence or as the loader's ref-deduped
    bank (expanded on the device), raw, or bit-packed (np.packbits along
    the width) when the canvas width is a multiple of 8;
  * on the host (`drain`): `recover_masks` + `nearest_resize`, cut at
    122/255, or in the reference-exact mode (`reference_exact`, which
    forces the host) the reference's own chain, `recover_masks_ref` (the
    bytescale + Pillow-bilinear paste) cut at > 122 and Pillow-NEAREST GT
    masks (`scipy_imresize`). The host also takes every image whose
    original extent exceeds the device buffers.
A detection-only model (no mask head, the `vgg` variant) is scored on
its boxes alone. In test mode 'top' each image draws its proposals'
random pad from a generator of its own, seeded from (cfg.seed, the
image's uid); the uids are given out in dispatch order, on the calling
thread. `eval_split` pipelines a split: `dispatch_image` enqueues an
image's work, `drain` reads it back.

Not ported yet (ROADMAP Queue 1 #4): the extent-crop wire, staged
uploads, several images a dispatch (`images_per_dispatch`) and
multi-device eval.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models.network import Lang2Seg, unpack_mask_bits
from ..ops.boxes import decode_boxes
from ..utils.metrics import (SegEvalAccumulator, nearest_resize,
                             recover_masks, recover_masks_ref,
                             scipy_imresize)


def _host_expand_bank(batch: Dict) -> Dict:
    """A batch whose ref-deduped mask bank is expanded to per-sentence
    `gt_masks` on the host (the host paste-back reads those); a batch
    without a bank as it is."""
    if "gt_mask_bank" not in batch or "gt_masks" in batch:
        return batch
    out = dict(batch)
    out["gt_masks"] = np.asarray(out.pop("gt_mask_bank"))[
        np.asarray(out.pop("mask_ref_idx"), np.int64)]
    return out


class Evaluator:
    def __init__(self, model: Lang2Seg, cfg: Config, device="cuda",
                 device_paste: bool = True, reference_exact: bool = False):
        """`device_paste` False pastes every mask back on the host;
        `reference_exact` reproduces the reference's metric chain on the
        host (pair it with cfg.data.reference_exact_masks for the
        loader's GT masks)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.reference_exact = reference_exact
        self.device_paste = device_paste and not reference_exact
        self._rng_uid = 0

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

    def _image_generator(self, uid: int) -> Optional[torch.Generator]:
        """Test mode 'top''s generator for the image of `uid`: a CPU
        generator seeded from (cfg.seed, uid); None in mode 'nms'."""
        if self.cfg.test.mode != "top":
            return None
        return torch.Generator().manual_seed((self.cfg.seed << 32) + uid)

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

    def _put(self, x, dtype=None) -> torch.Tensor:
        """A host array on the device. To the card it goes from pinned
        memory without blocking the host, so that the host can build the
        next image while the card works."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @torch.no_grad()
    def dispatch_image(self, batch: Dict[str, np.ndarray],
                       sent_valid: Optional[np.ndarray] = None) -> Dict:
        """Enqueue all the device work of one image and return a record of
        device tensors for `drain`, without reading anything back. On the
        device-paste path that is the forward, the box selection, the
        mask branch and the paste-back with its I / U counts (GT masks
        per sentence, `gt_masks`, or as the ref-deduped bank,
        `gt_mask_bank` with `mask_ref_idx`, expanded on the device); on
        the host path the forward, the selection and the mask branch's
        probabilities (none without a mask head)."""
        m, d = self.cfg.model, self.cfg.data
        scale, sh, sw, ih, iw = self._extents(batch)
        self._rng_uid += 1
        gen = self._image_generator(self._rng_uid)
        rec = {"batch": batch, "scale": scale, "sent_valid": sent_valid,
               "sh": sh, "sw": sw, "ih": ih, "iw": iw}
        on_device = m.use_mask_head and self.device_paste and \
            self._fits(ih, iw)
        if on_device:
            use_bank = "gt_mask_bank" in batch
            gm = np.asarray(batch["gt_mask_bank" if use_bank else "gt_masks"])
            packed = gm.shape[-1] % 8 == 0
            gm_dev = self._put(np.packbits(gm > 0, axis=-1) if packed
                               else gm)
            if use_bank:
                gm_dev = gm_dev.index_select(
                    0, self._put(batch["mask_ref_idx"], torch.int64))
        elif m.use_mask_head:
            rec["batch"] = _host_expand_bank(batch)
        out = self.model.test_forward({
            "images": self._put(batch["images"]),
            "im_hw": self._put(batch["im_hw"], torch.float32),
            "labels": self._put(batch["labels"])}, gen)
        scale_t, ih_t, iw_t = self._put(np.float32([scale, ih, iw]))
        sel, cls = self._select_fn(
            out["rois"], out["bbox_pred"], out["cls_prob"], out["roi_valid"],
            scale_t, ih_t, iw_t)
        rec["sel"] = sel
        if not m.use_mask_head:
            return rec
        probs = self.model.predict_masks(
            out["gated_conv"], (sel * scale_t)[:, None, :], cls[:, None])[:, 0]
        if on_device:
            rec["inter"], rec["union"] = self._paste_iou_fn(
                probs, sel, gm_dev, sh, sw, ih, iw,
                oh=d.max_orig_h, ow=d.max_orig_w, packed=packed)
        else:
            rec["probs"] = probs
        return rec

    def drain(self, rec: Dict, acc: SegEvalAccumulator) -> None:
        """Read one dispatched image's results back and accumulate them:
        detections always; the device's I / U counts, or the masks pasted
        back here."""
        sel = rec["sel"].cpu().numpy()
        sent_valid = rec["sent_valid"]
        live = [i for i in range(sel.shape[0])
                if sent_valid is None or sent_valid[i]]
        batch, scale = rec["batch"], rec["scale"]
        for i in live:
            gt_box = np.asarray(batch["gt_boxes"][i, :4]) / scale
            acc.add_detection(sel[i], gt_box)
        if "inter" in rec:
            inter = rec["inter"].cpu().numpy()
            union = rec["union"].cpu().numpy()
            for i in live:
                acc.add_segmentation_iu(int(inter[i]), int(union[i]))
        elif "probs" in rec:
            probs = rec["probs"].float().cpu().numpy()
            sh, sw, ih, iw = rec["sh"], rec["sw"], rec["ih"], rec["iw"]
            for i in live:
                gm = np.asarray(batch["gt_masks"][i])[:sh, :sw]
                box = sel[i:i + 1].copy()
                if self.reference_exact:
                    # bytescale + Pillow-bilinear paste (mask_utils.py:
                    # 43-72), the > 122 cut (test.py:334), Pillow-NEAREST
                    # GT resize (test.py:338)
                    pred = recover_masks_ref(probs[i:i + 1], box, ih,
                                             iw)[0] > 122.0
                    gt = scipy_imresize(gm, (ih, iw), "nearest")
                else:
                    pred = recover_masks(probs[i:i + 1], box, ih,
                                         iw)[0] * 255.0 > 122.0
                    gt = nearest_resize(gm, ih, iw)
                acc.add_segmentation(pred.astype(np.uint8), gt)

    def eval_image(self, batch: Dict[str, np.ndarray],
                   acc: SegEvalAccumulator,
                   sent_valid: Optional[np.ndarray] = None) -> None:
        """batch: images (1, H, W, 3), im_hw (1, 2), labels (S, T),
        gt_boxes (S, 5) scaled, gt_masks (S, Hc, Wc) (or the mask bank),
        im_scale scalar. sent_valid: (S,) bool mask for padded sentence
        slots."""
        self.drain(self.dispatch_image(batch, sent_valid), acc)

    def eval_split(self, batches: Iterable[Dict[str, np.ndarray]],
                   verbose: bool = False, pipeline_depth: int = 4,
                   images_per_dispatch: int = 1,
                   acc: Optional[SegEvalAccumulator] = None
                   ) -> Dict[str, float]:
        """Score every image of `batches` (e.g. GtBatchLoader.
        iter_test_batches), one image a dispatch, keeping up to
        `pipeline_depth` dispatched images ahead of the drain, so that
        the host builds and uploads the next image while the card works.
        Each batch's own `sent_valid` marks its padded slots. Returns the
        summary of `acc` (a fresh accumulator by default)."""
        if images_per_dispatch > 1:
            raise NotImplementedError(
                "images_per_dispatch > 1 is not ported (ROADMAP Queue 1 #4)")
        acc = SegEvalAccumulator() if acc is None else acc
        pending = deque()
        done = 0

        def drain_one():
            nonlocal done
            self.drain(pending.popleft(), acc)
            done += 1
            if verbose and done % 20 == 0:
                s = acc.summary()
                print(f"[eval] {done} images: det_acc={s['det_acc']:.4f} "
                      f"IoU={s['overall_iou']:.4f}", flush=True)

        was_training = self.model.training
        self.model.eval()
        try:
            for batch in batches:
                pending.append(self.dispatch_image(batch,
                                                   batch.get("sent_valid")))
                if len(pending) >= max(1, pipeline_depth):
                    drain_one()
            while pending:
                drain_one()
        finally:
            self.model.train(was_training)
        return acc.summary()
