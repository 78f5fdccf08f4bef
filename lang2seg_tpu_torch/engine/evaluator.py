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
image's uid); the uids are given out on the calling thread in the order
the images arrive, so that every mode below gives an image the same uid,
and the same draws, as one image a dispatch. `eval_split` pipelines a
split: `dispatch_image` (or `_dispatch_chunk`) enqueues the work,
`drain` reads it back.

The JAX Evaluator's throughput modes, each scoring exactly what one image
a dispatch scores:
  * the extent-crop wire (cfg.data.wire_extent_crop): a uint8 canvas and
    its GT masks travel as the content extent rounded up to
    wire_extent_granularity; `_inflate` re-creates the loader's full
    canvases on the device (rounded pixel means, zero masks beyond it);
  * several images a dispatch (`eval_split(images_per_dispatch=N)`): N
    images of one sentence bucket and bank row count stacked into one
    `test_forward` of N x S expressions (the backbone once an image, the
    gate reading each image's map in place, one NMS over N x S lanes), in
    power-of-two chunks for a bucket's remainder; images beyond the paste
    buffers, the host paste-back, the reference-exact mode and
    detection-only models go one image a dispatch;
  * staged uploads (`stage_uploads`): one worker thread stacks the next
    chunk (bit-packing, crop) and starts its host -> device copies from
    pinned memory on a copy stream of its own, while the card computes
    the chunks before it; the compute stream waits on the copies' event
    when the chunk is dispatched. The worker launches no model kernel.

Several ranks (`eval_split_mesh`, the JAX package's device-parallel
eval): rank r of a `parallel.Mesh` of n takes images r, r + n, ... of
each sentence bucket, in the split's order, through the same dispatch
paths (`images_per_dispatch` included), with the uids `eval_split` would
give them; each image's detections and I / U counts are gathered from
every rank and accumulated in the split's image order, so the summary is
`eval_split`'s. JAX pads its last chunk for SPMD; a rank here just takes
fewer images.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models.network import Lang2Seg, unpack_mask_bits
from ..ops.boxes import decode_boxes
from ..utils.metrics import (SegEvalAccumulator, nearest_resize,
                             recover_masks, recover_masks_ref,
                             scipy_imresize)
from ..utils.trace import count, span


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


class _ImageRecord(SegEvalAccumulator):
    """One image's detections and I / U counts, kept in arrival order
    (`events`) for `eval_split_mesh` to replay in the split's order."""

    def __init__(self):
        super().__init__()
        self.events: List[tuple] = []

    def add_detection(self, pred_box, gt_box):
        self.events.append(("det", np.asarray(pred_box), np.asarray(gt_box)))

    def add_segmentation_iu(self, i: float, u: float):
        self.events.append(("iu", i, u))


class _ImageLog:
    """An accumulator that keeps each image apart, by its uid."""

    def __init__(self):
        self.images: Dict[int, _ImageRecord] = {}

    def image(self, uid: int) -> _ImageRecord:
        return self.images.setdefault(uid, _ImageRecord())


def _image_acc(acc, uid: int):
    """Where an image's results go: its own record in an `_ImageLog`, or
    the one accumulator."""
    return acc.image(uid) if isinstance(acc, _ImageLog) else acc


def _valid_of(batch: Dict, sent_valid=None) -> np.ndarray:
    """(S,) bool: `sent_valid`, every slot when it is None."""
    return (np.ones(batch["labels"].shape[0], bool) if sent_valid is None
            else np.asarray(sent_valid, bool))


class Evaluator:
    def __init__(self, model: Lang2Seg, cfg: Config, device="cuda",
                 device_paste: bool = True, reference_exact: bool = False):
        """`device_paste` False pastes every mask back on the host;
        `reference_exact` reproduces the reference's metric chain on the
        host (pair it with cfg.data.reference_exact_masks for the
        loader's GT masks). The counters `eval.h2d_bytes` and
        `eval.images` (`utils/trace.py`) count the bytes copied to the
        device and the images dispatched."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.reference_exact = reference_exact
        self.device_paste = device_paste and not reference_exact
        d = cfg.data
        self._extent_crop = bool(d.wire_extent_crop)
        self._extent_g = int(d.wire_extent_granularity)
        if self._extent_crop and (self._extent_g <= 0
                                  or self._extent_g % 8):
            raise ValueError(
                f"cfg.data.wire_extent_granularity must be a positive "
                f"multiple of 8 (bit-packed masks crop at byte boundaries), "
                f"got {self._extent_g}")
        self._means_u8 = [int(v) for v in
                          np.round(np.asarray(d.pixel_means_bgr))]
        self._rng_uid = 0
        self._copy_stream = None

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

    def _next_uid(self) -> int:
        self._rng_uid += 1
        return self._rng_uid

    def _image_generator(self, uid: int) -> Optional[torch.Generator]:
        """Test mode 'top''s generator for the image of `uid`: a CPU
        generator seeded from (cfg.seed, uid); None in mode 'nms'."""
        if self.cfg.test.mode != "top":
            return None
        return torch.Generator().manual_seed((self.cfg.seed << 32) + uid)

    def _crop_extent(self, sh: int, sw: int):
        """The bucketed content extent (hb, wb) that the extent-crop wire
        ships for a scaled extent (sh, sw): each side rounded up to
        wire_extent_granularity, at most the canvas; None when the wire is
        off or the crop would drop no canvas byte."""
        if not self._extent_crop:
            return None
        g, d = self._extent_g, self.cfg.data
        hb = min(d.canvas_h, -(-int(sh) // g) * g)
        wb = min(d.canvas_w, -(-int(sw) // g) * g)
        if hb >= d.canvas_h and wb >= d.canvas_w:
            return None
        return hb, wb

    def _inflate(self, images: torch.Tensor, masks: torch.Tensor,
                 mask_w: int):
        """The loader's full canvases from content-extent crops, on the
        crops' device: images (..., hb, wb, 3) uint8 -> (..., canvas_h,
        canvas_w, 3) filled with the rounded pixel means beyond the crop
        (what the loader writes outside the content extent), masks (...,
        hb, wm) uint8, raw or bit-packed -> (..., canvas_h, mask_w)
        zero-filled (the loader writes masks only inside the extent)."""
        d = self.cfg.data
        ch, cw = d.canvas_h, d.canvas_w
        hb, wb = images.shape[-3], images.shape[-2]
        full = torch.empty((*images.shape[:-3], ch, cw, 3),
                           dtype=torch.uint8, device=images.device)
        for c, v in enumerate(self._means_u8):
            full[..., c].fill_(v)
        full[..., :hb, :wb, :] = images
        mfull = torch.zeros((*masks.shape[:-2], ch, mask_w),
                            dtype=torch.uint8, device=masks.device)
        mfull[..., :masks.shape[-2], :masks.shape[-1]] = masks
        return full, mfull

    @staticmethod
    @span("l2s.select")
    def _select_fn(rois, deltas, scores, valid, scale, ih, iw):
        """Batched argmax protocol over all S sentences (test.py:256-259):
        decode per-class boxes in original-image coords, mask padded rois,
        global argmax over scores[:, 1:], select that class's box.
        scale / ih / iw: f32 tensors on the rois' device, one for all
        sentences (0-dim) or one a sentence ((S,))."""
        s, r, _ = rois.shape
        num_classes = scores.shape[-1]
        scale, ih, iw = (v.reshape(-1, 1, 1) if v.dim() else v
                         for v in (scale, ih, iw))
        pred = decode_boxes(rois / scale, deltas)           # (S, R, 4K)
        pk = pred.reshape(s, r, num_classes, 4)
        lim = torch.stack([iw, ih, iw, ih], dim=-1) - 1.0   # (4,) | (S,1,1,4)
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
    @span("l2s.paste")
    def _paste_iou_fn(mask_probs, boxes, gt_masks, sh, sw, ih, iw, *,
                      oh: int, ow: int, packed: bool = False):
        """Device paste-back + IoU, batched over sentences.

        mask_probs (S, M, M) in [0, 1]; boxes (S, 4) xyxy in original
        image coords; gt_masks (S, Hc, Wc) uint8 canvas masks, or
        (S, Hc, Wc // 8) bit-packed MSB-first; sh / sw the scaled extent,
        ih / iw the original extent: ints, or int tensors on the masks'
        device, one for all sentences or one a sentence ((S,)). Returns
        per-sentence (I, U) pixel counts over each (ih, iw) region."""
        s, m, _ = mask_probs.shape
        dev = mask_probs.device
        if packed:
            gt_masks = unpack_mask_bits(gt_masks)
        sh, sw, ih, iw = (torch.as_tensor(v, device=dev).reshape(-1)
                          for v in (sh, sw, ih, iw))

        # int-truncated, clipped box corners (recover_masks semantics)
        hi_x, hi_y = (iw - 1).float(), (ih - 1).float()

        def corner(v, hi):
            return torch.clamp(torch.clamp(v, min=0.0), max=hi).to(
                torch.int32)

        x1, y1 = corner(boxes[:, 0], hi_x), corner(boxes[:, 1], hi_y)
        x2, y2 = corner(boxes[:, 2], hi_x), corner(boxes[:, 3], hi_y)
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
        ys = ((2 * torch.arange(oh, device=dev) + 1)[None] * sh[:, None]
              // (2 * torch.clamp(ih, min=1))[:, None])
        xs = ((2 * torch.arange(ow, device=dev) + 1)[None] * sw[:, None]
              // (2 * torch.clamp(iw, min=1))[:, None])
        ys = torch.clamp(ys, 0, gt_masks.shape[1] - 1).expand(s, oh)
        xs = torch.clamp(xs, 0, gt_masks.shape[2] - 1).expand(s, ow)
        rows = torch.gather(gt_masks, 1, ys[:, :, None].expand(
            s, oh, gt_masks.shape[2]))                         # (S, oh, Wc)
        gt = torch.gather(rows, 2, xs[:, None, :].expand(s, oh, ow)) > 0

        valid = ((torch.arange(oh, device=dev)[None, :, None]
                  < ih[:, None, None])
                 & (torch.arange(ow, device=dev)[None, None, :]
                    < iw[:, None, None]))
        inter = (pred & gt & valid).sum(dim=(1, 2))
        union = ((pred | gt) & valid).sum(dim=(1, 2))
        return inter.to(torch.int32), union.to(torch.int32)

    def _to_device(self, x, dtype=None) -> torch.Tensor:
        """A host array on the device, on the current stream: from pinned
        memory without blocking the host on a card. Returns (tensor, bytes
        copied)."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is not None:
            t = t.to(dtype)
        nbytes = t.numel() * t.element_size()
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t, nbytes

    def _put(self, x, dtype=None) -> torch.Tensor:
        """`_to_device`, counted in `eval.h2d_bytes` (calling thread
        only)."""
        t, nbytes = self._to_device(x, dtype)
        count("eval.h2d_bytes", nbytes)
        return t

    @span("l2s.stack")
    def _stack_chunk(self, chunk: List[Dict], uids: List[int]) -> Dict:
        """The host operands of one dispatch of `chunk`'s images, which
        share a sentence bucket S (and, for the bank wire, the bank's row
        count R), with the image uids given on the calling thread: images
        (N, H, W, 3), im_hw (N, 2), labels (N * S, T), GT masks (N, S | R,
        Hc, Wm) bit-packed where the width allows, the bank's per-sentence
        rows as flat indices into the N * R rows, and the per-sentence
        scale (f32) and [sh, sw, ih, iw] (int64). A uint8 chunk on the
        extent-crop wire ships the chunk's largest bucketed content
        extent only (`crop`: the mask width to inflate to)."""
        s = chunk[0]["labels"].shape[0]
        if any(b["labels"].shape[0] != s for b in chunk):
            raise ValueError("a chunk needs a uniform sentence bucket")
        exts = [self._extents(b) for b in chunk]
        if not all(self._fits(e[3], e[4]) for e in exts):
            raise ValueError("original extents exceed the device-paste "
                             "buffers")
        use_bank = "gt_mask_bank" in chunk[0]
        gms = [np.asarray(b["gt_mask_bank" if use_bank else "gt_masks"])
               for b in chunk]
        if any(g.shape != gms[0].shape for g in gms):
            raise ValueError("a chunk needs a uniform mask bank row count")
        packed = gms[0].shape[-1] % 8 == 0
        images = np.concatenate([np.asarray(b["images"]) for b in chunk])
        crop = None
        ext = (self._crop_extent(max(e[1] for e in exts),
                                 max(e[2] for e in exts))
               if images.dtype == np.uint8 else None)
        if ext is not None:
            hb, wb = ext
            crop = gms[0].shape[-1] // 8 if packed else gms[0].shape[-1]
            images = images[:, :hb, :wb]
            gms = [g[..., :hb, :wb] for g in gms]
        arrays = {
            "images": images,
            "im_hw": np.concatenate([np.asarray(b["im_hw"], np.float32)
                                     for b in chunk]),
            "labels": np.concatenate([np.asarray(b["labels"])
                                      for b in chunk]),
            "gm": np.stack([np.packbits(g > 0, axis=-1) if packed else g
                            for g in gms]),
            "scale": np.repeat(np.float32([e[0] for e in exts]), s),
            "ext": np.repeat(np.int64([e[1:] for e in exts]).T, s, axis=1)}
        if use_bank:
            rows = gms[0].shape[0]
            arrays["ref_idx"] = np.concatenate([
                np.asarray(b["mask_ref_idx"], np.int64) + i * rows
                for i, b in enumerate(chunk)])
        return {"arrays": arrays, "scales": [e[0] for e in exts], "s": s,
                "packed": packed, "crop": crop, "uids": list(uids)}

    @span("l2s.stage")
    def _stage_chunk(self, chunk: List[Dict], valid_flags, uids: List[int],
                     staged: bool = False) -> Dict:
        """The host half of a chunk's dispatch: `_stack_chunk`, then the
        operands' copies to the device. `staged` (a worker thread of
        `eval_split`) copies from pinned memory on the evaluator's copy
        stream and records an event that the dispatch waits on; otherwise
        the copies go on the current stream. Touches no evaluator state
        but the copy stream."""
        st = self._stack_chunk(chunk, uids)
        st.update(chunk=chunk, valid_flags=valid_flags, event=None)
        arrays = st.pop("arrays")
        if staged and self.device.type == "cuda":
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._copy_stream):
                with span("l2s.upload"):
                    ops = {k: self._to_device(v) for k, v in arrays.items()}
                st["event"] = torch.cuda.Event()
                st["event"].record(self._copy_stream)
        else:
            with span("l2s.upload"):
                ops = {k: self._to_device(v) for k, v in arrays.items()}
        st["ops"] = {k: t for k, (t, _) in ops.items()}
        st["bytes"] = sum(n for _, n in ops.values())
        return st

    @torch.no_grad()
    @span("l2s.dispatch")
    def _dispatch_staged(self, st: Dict) -> Dict:
        """The device half: after the staged copies (the compute stream
        waits on their event and owns their tensors from here), re-create
        cropped canvases and enqueue the whole eval of the chunk's N x S
        expressions (the forward, the box selection, the mask branch, the
        paste-back with its I / U counts), without reading anything back.
        Returns the record `drain` reads."""
        ops = st["ops"]
        if st["event"] is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(st["event"])
            for t in ops.values():
                t.record_stream(stream)
        count("eval.h2d_bytes", st["bytes"])
        count("eval.images", len(st["chunk"]))
        images, gm = ops["images"], ops["gm"]
        if st["crop"] is not None:
            images, gm = self._inflate(images, gm, st["crop"])
        gm = gm.reshape(-1, *gm.shape[-2:])
        if "ref_idx" in ops:                 # the bank, expanded here
            gm = gm.index_select(0, ops["ref_idx"])
        out = self.model.test_forward(
            {"images": images, "im_hw": ops["im_hw"],
             "labels": ops["labels"]},
            [self._image_generator(u) for u in st["uids"]])
        scale = ops["scale"]
        sh, sw, ih, iw = ops["ext"]
        sel, cls = self._select_fn(
            out["rois"], out["bbox_pred"], out["cls_prob"], out["roi_valid"],
            scale, ih.float(), iw.float())
        probs = self.model.predict_masks(
            out["gated_conv"], (sel * scale[:, None])[:, None, :],
            cls[:, None])[:, 0]
        d = self.cfg.data
        inter, union = self._paste_iou_fn(
            probs, sel, gm, sh, sw, ih, iw, oh=d.max_orig_h, ow=d.max_orig_w,
            packed=st["packed"])
        return {"chunk": st["chunk"], "valid_flags": st["valid_flags"],
                "scales": st["scales"], "s": st["s"], "uids": st["uids"],
                "sel": sel, "inter": inter, "union": union}

    def _dispatch_chunk(self, chunk: List[Dict], valid_flags,
                        uids: List[int]) -> Dict:
        """Stack, upload and dispatch one chunk on the calling thread."""
        return self._dispatch_staged(self._stage_chunk(chunk, valid_flags,
                                                       uids))

    def _drain_chunk(self, rec: Dict, acc: SegEvalAccumulator) -> int:
        """Read a chunk's results back and accumulate its valid sentences;
        returns its image count."""
        n, s = len(rec["chunk"]), rec["s"]
        with span("l2s.sync.readback"):
            sel = rec["sel"].cpu().numpy().reshape(n, s, 4)
            inter = rec["inter"].cpu().numpy().reshape(n, s)
            union = rec["union"].cpu().numpy().reshape(n, s)
        with span("l2s.accumulate"):
            for d, b in enumerate(rec["chunk"]):
                a = _image_acc(acc, rec["uids"][d])
                for i in np.flatnonzero(rec["valid_flags"][d]):
                    gt_box = np.asarray(b["gt_boxes"][i, :4]) / \
                        rec["scales"][d]
                    a.add_detection(sel[d, i], gt_box)
                    a.add_segmentation_iu(int(inter[d, i]),
                                          int(union[d, i]))
        return n

    @torch.no_grad()
    def dispatch_image(self, batch: Dict[str, np.ndarray],
                       sent_valid: Optional[np.ndarray] = None,
                       uid: Optional[int] = None) -> Dict:
        """Enqueue all the device work of one image and return a record of
        device tensors for `drain`, without reading anything back. On the
        device-paste path that is a chunk of one image (`_dispatch_chunk`:
        the forward, the box selection, the mask branch and the
        paste-back with its I / U counts; GT masks per sentence,
        `gt_masks`, or as the ref-deduped bank, `gt_mask_bank` with
        `mask_ref_idx`, expanded on the device; a uint8 canvas on the
        extent-crop wire); on the host path the forward, the selection
        and the mask branch's probabilities (none without a mask head).
        The image's uid is given out here, unless the caller gives it."""
        m = self.cfg.model
        scale, sh, sw, ih, iw = self._extents(batch)
        if uid is None:
            uid = self._next_uid()
        if m.use_mask_head and self.device_paste and self._fits(ih, iw):
            # `_stage_chunk` and `_dispatch_staged` open their own spans
            return self._dispatch_chunk(
                [batch], [_valid_of(batch, sent_valid)], [uid])
        rec = {"batch": batch, "scale": scale, "sent_valid": sent_valid,
               "sh": sh, "sw": sw, "ih": ih, "iw": iw, "uid": uid}
        if m.use_mask_head:
            rec["batch"] = _host_expand_bank(batch)
        with span("l2s.dispatch"):
            count("eval.images")
            with span("l2s.upload"):
                inputs = {"images": self._put(batch["images"]),
                          "im_hw": self._put(batch["im_hw"], torch.float32),
                          "labels": self._put(batch["labels"])}
            out = self.model.test_forward(inputs, self._image_generator(uid))
            with span("l2s.upload"):
                scale_t, ih_t, iw_t = self._put(np.float32([scale, ih, iw]))
            sel, cls = self._select_fn(
                out["rois"], out["bbox_pred"], out["cls_prob"],
                out["roi_valid"], scale_t, ih_t, iw_t)
            rec["sel"] = sel
            if m.use_mask_head:
                rec["probs"] = self.model.predict_masks(
                    out["gated_conv"], (sel * scale_t)[:, None, :],
                    cls[:, None])[:, 0]
        return rec

    def drain(self, rec: Dict, acc: SegEvalAccumulator) -> None:
        """Read one dispatched record back and accumulate it: a chunk's
        detections and device I / U counts, or one image's detections and
        the masks pasted back here."""
        if "chunk" in rec:
            self._drain_chunk(rec, acc)
            return
        with span("l2s.sync.readback"):
            sel = rec["sel"].cpu().numpy()
            probs = (rec["probs"].float().cpu().numpy() if "probs" in rec
                     else None)
        with span("l2s.accumulate"):
            self._accumulate_image(rec, sel, probs,
                                   _image_acc(acc, rec.get("uid")))

    def _accumulate_image(self, rec: Dict, sel: np.ndarray,
                          probs: Optional[np.ndarray], acc) -> None:
        """One host-path image's detections and, with `probs`, its masks
        pasted back here, into `acc`."""
        sent_valid = rec["sent_valid"]
        live = [i for i in range(sel.shape[0])
                if sent_valid is None or sent_valid[i]]
        batch, scale = rec["batch"], rec["scale"]
        for i in live:
            gt_box = np.asarray(batch["gt_boxes"][i, :4]) / scale
            acc.add_detection(sel[i], gt_box)
        if probs is not None:
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

    @span("l2s.request")
    def eval_image(self, batch: Dict[str, np.ndarray],
                   acc: SegEvalAccumulator,
                   sent_valid: Optional[np.ndarray] = None) -> None:
        """batch: images (1, H, W, 3), im_hw (1, 2), labels (S, T),
        gt_boxes (S, 5) scaled, gt_masks (S, Hc, Wc) (or the mask bank),
        im_scale scalar. sent_valid: (S,) bool mask for padded sentence
        slots."""
        self.drain(self.dispatch_image(batch, sent_valid), acc)

    @span("l2s.eval_split")
    def eval_split(self, batches: Iterable[Dict[str, np.ndarray]],
                   verbose: bool = False, pipeline_depth: int = 4,
                   images_per_dispatch: int = 1, stage_uploads: bool = True,
                   acc: Optional[SegEvalAccumulator] = None
                   ) -> Dict[str, float]:
        """Score every image of `batches` (e.g. GtBatchLoader.
        iter_test_batches), keeping up to `pipeline_depth` dispatches
        ahead of the drain, so that the host builds and uploads the next
        images while the card works. Each batch's own `sent_valid` marks
        its padded slots. Returns the summary of `acc` (a fresh
        accumulator by default).

        images_per_dispatch N > 1 dispatches N images of one sentence
        bucket and bank row count at once (the device paste-back only):
        full groups at N, a bucket's remainder at the end in power-of-two
        chunks, so that a run meets at most log2(N) + 1 chunk sizes a
        bucket; an image beyond the paste buffers goes alone, when it
        arrives. `stage_uploads` then stacks and uploads each chunk on a
        worker thread, one chunk ahead of the dispatches."""
        acc = SegEvalAccumulator() if acc is None else acc
        self._eval_images(((b, None) for b in batches), acc,
                          verbose, pipeline_depth, images_per_dispatch,
                          stage_uploads)
        return acc.summary()

    def eval_split_mesh(self, batches: Iterable[Dict[str, np.ndarray]],
                        mesh, verbose: bool = False, pipeline_depth: int = 4,
                        images_per_dispatch: int = 1,
                        stage_uploads: bool = True,
                        acc: Optional[SegEvalAccumulator] = None
                        ) -> Dict[str, float]:
        """`eval_split` over the ranks of `mesh` (parallel/mesh.py): every
        rank passes the same batches and gets the same summary (of `acc`,
        a fresh accumulator by default). Rank r
        scores images r, r + n, ... of each sentence bucket (in the
        split's order, through `eval_split`'s dispatch paths); the
        per-image results are gathered from every rank and accumulated in
        the split's image order. Each image keeps the uid `eval_split`
        gives it."""
        import torch.distributed as dist
        batches = list(batches)
        uids = [self._rng_uid + 1 + i for i in range(len(batches))]
        self._rng_uid += len(batches)
        buckets: Dict[int, List[int]] = {}
        for i, b in enumerate(batches):
            buckets.setdefault(b["labels"].shape[0], []).append(i)
        mine = sorted(i for idx in buckets.values()
                      for i in idx[mesh.rank::mesh.size])
        log = _ImageLog()
        self._eval_images(((batches[i], uids[i]) for i in mine), log,
                          verbose, pipeline_depth, images_per_dispatch,
                          stage_uploads)
        gathered = [None] * mesh.size
        dist.all_gather_object(
            gathered, {u: r.events for u, r in log.images.items()},
            group=mesh.group)
        events: Dict[int, List[tuple]] = {}
        for part in gathered:
            events.update(part)
        acc = SegEvalAccumulator() if acc is None else acc
        for u in uids:
            for kind, a, b in events.get(u, ()):
                if kind == "det":
                    acc.add_detection(a, b)
                else:
                    acc.add_segmentation_iu(a, b)
        return acc.summary()

    def _eval_images(self, items, acc, verbose: bool, pipeline_depth: int,
                     images_per_dispatch: int, stage_uploads: bool) -> None:
        """`eval_split`'s pipeline over (batch, uid) pairs into `acc`; a
        None uid is given out as the image arrives."""
        pending, staged = deque(), deque()
        groups: Dict[tuple, list] = {}
        n_batch = max(1, images_per_dispatch)
        use_chunks = (n_batch > 1 and self.cfg.model.use_mask_head
                      and self.device_paste)
        pool = None
        if use_chunks and stage_uploads:
            pool = ThreadPoolExecutor(max_workers=1)
            if self.device.type == "cuda" and self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
        done = 0

        def drain_one():
            nonlocal done
            prev = done
            rec = pending.popleft()
            self.drain(rec, acc)
            done += len(rec["chunk"]) if "chunk" in rec else 1
            # chunks advance the count by more than one image: print
            # whenever a multiple of 20 is crossed
            if verbose and done // 20 > prev // 20 and \
                    isinstance(acc, SegEvalAccumulator):
                s = acc.summary()
                print(f"[eval] {done} images: det_acc={s['det_acc']:.4f} "
                      f"IoU={s['overall_iou']:.4f}", flush=True)

        def staged_result():
            with span("l2s.wait.staged"):
                return staged.popleft().result()

        def flush(key):
            group = groups.pop(key, [])
            while group:
                take = (n_batch if len(group) >= n_batch
                        else 1 << (len(group).bit_length() - 1))
                sub, group = group[:take], group[take:]
                args = tuple(list(x) for x in zip(*sub))
                if pool is None:
                    pending.append(self._dispatch_chunk(*args))
                    continue
                staged.append(pool.submit(self._stage_chunk, *args, True))
                # one chunk's stacking and upload stays in flight behind
                # the dispatches
                while len(staged) > 1:
                    pending.append(self._dispatch_staged(staged_result()))

        was_training = self.model.training
        self.model.eval()
        try:
            for batch, uid in items:
                if use_chunks and self._fits(*self._extents(batch)[3:]):
                    key = (batch["labels"].shape[0],
                           batch["gt_mask_bank"].shape[0]
                           if "gt_mask_bank" in batch else -1)
                    groups.setdefault(key, []).append(
                        (batch, _valid_of(batch, batch.get("sent_valid")),
                         self._next_uid() if uid is None else uid))
                    if len(groups[key]) >= n_batch:
                        flush(key)
                elif uid is None:
                    pending.append(self.dispatch_image(
                        batch, batch.get("sent_valid")))
                else:
                    pending.append(self.dispatch_image(
                        batch, batch.get("sent_valid"), uid))
                if len(pending) >= max(1, pipeline_depth):
                    drain_one()
            for key in list(groups):
                flush(key)
            while staged:
                pending.append(self._dispatch_staged(staged_result()))
            while pending:
                drain_one()
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
            self.model.train(was_training)
