"""Training and evaluation batches from REFER-format data.

Counterpart of `lang2seg_tpu/data/loader.py` (reference loaders
`lib/loaders/loader.py:70-167`, `gt_mrcn_loader.py:143-851`,
`cycle_loader.py:297-309`):
  * `Loader`: vocabulary and the ref / image / ann / sentence tables of a
    prepro `data.json`, and the (N, L) int32 token labels of `data.h5`;
  * `GtBatchLoader`: a shuffled epoch over each split's images (numpy
    `RandomState`, the same draws as the JAX loader for the same seed);
    an image is resized by the reference rule (short side 600, long side
    at most 1000), further capped to the fixed canvas, and placed
    top-left on it; GT boxes xywh -> xyxy, scaled; GT masks decoded from
    each ref's RLE and nearest-resized onto the canvas. Train batches
    hold I images and E expressions drawn from their (ref, sentence)
    pool; test batches one image with all its sentences of a split,
    padded to a sentence bucket, with the ref-deduped mask bank; with an
    attribute vocabulary (`att_to_ix`) and cfg.model.use_attribute_head,
    train batches carry `att_labels` / `att_valid`, and
    `iter_attribute_batches` gives each image's attribute-bearing refs;
  * `CycleBatchLoader`: caption targets always on.

`data_json` is a path or the parsed dict, `data_h5` a path or the label
array; `read_image(path)` returns a BGR uint8 image (default
`cv2.imread`). `h5py` and `cv2` are imported only where a file is
opened, so the module imports without them. The canvas resize is the
port's own copy of cv2's INTER_LINEAR rule (`resize_linear`).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ..config import Config
from ..utils.metrics import scipy_imresize
from . import rle as rle_codec


def xywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    out = boxes.astype(np.float32).copy()
    out[..., 2] = out[..., 0] + out[..., 2] - 1
    out[..., 3] = out[..., 1] + out[..., 3] - 1
    return out


def caption_targets(labels: np.ndarray) -> Dict[str, np.ndarray]:
    """(E, L) token ids, 0 pad -> the captioner's targets: `cap_labels`
    (E, L + 2) int32, BOS = 0 in column 0, the tokens, then 0s (the first
    is EOS), and `cap_masks` (E, L + 2) f32, 1 over BOS, the tokens and
    the EOS."""
    e, length = labels.shape
    cap = np.zeros((e, length + 2), np.int32)
    cap[:, 1:-1] = labels
    nonzeros = (cap != 0).sum(axis=1) + 2
    mask = (np.arange(length + 2)[None, :] < nonzeros[:, None]).astype(
        np.float32)
    return {"cap_labels": cap, "cap_masks": mask}


def _linear_taps(n_out: int, n_in: int, scale: float):
    """Source rows (or columns) and weight of cv2.resize's INTER_LINEAR
    along one axis: output i samples src = (i + 0.5) / scale - 0.5 in
    double, split into floor and an f32 fraction, clamped at both edges to
    one tap (fraction 0)."""
    src = (np.arange(n_out) + 0.5) * (1.0 / scale) - 0.5
    s0 = np.floor(src).astype(np.int64)
    frac = (src - s0).astype(np.float32)
    frac[(s0 < 0) | (s0 >= n_in - 1)] = 0.0
    s0 = np.clip(s0, 0, n_in - 1)
    return s0, np.minimum(s0 + 1, n_in - 1), frac.astype(np.float64)


def _lerp(a: np.ndarray, b: np.ndarray, frac: np.ndarray) -> np.ndarray:
    """a + (b - a) * frac of f32 arrays with one rounding of the product
    and sum (a fused multiply-add), as cv2 blends its two taps."""
    return (a.astype(np.float64) + (b - a).astype(np.float64) * frac
            ).astype(np.float32)


def resize_linear(im: np.ndarray, scale: float) -> np.ndarray:
    """(h, w, c) image -> (round(h * scale), round(w * scale), c) f32, as
    cv2.resize(im.astype(np.float32), None, fx=scale, fy=scale,
    interpolation=cv2.INTER_LINEAR) computes it: separable, the width
    first, no antialiasing (within 2 f32 ulps of cv2 on 3 channels)."""
    h, w = im.shape[:2]
    oh, ow = int(round(h * scale)), int(round(w * scale))
    im = im.astype(np.float32, copy=False)
    x0, x1, fx = _linear_taps(ow, w, scale)
    rows = _lerp(im[:, x0], im[:, x1], fx[:, None])
    y0, y1, fy = _linear_taps(oh, h, scale)
    return _lerp(rows[y0], rows[y1], fy[:, None, None])


def _cv2_imread(path: str) -> Optional[np.ndarray]:
    import cv2
    return cv2.imread(path)


class Loader:
    """Vocabulary and index tables (reference loader.py:70-167)."""

    def __init__(self, data_json: Union[str, Dict],
                 data_h5: Union[str, np.ndarray, None] = None):
        if isinstance(data_json, dict):
            info = data_json
        else:
            with open(data_json) as f:
                info = json.load(f)
        self.word_to_ix: Dict[str, int] = info["word_to_ix"]
        self.ix_to_word = {int(k): v for k, v in info["ix_to_word"].items()}
        self.vocab_size = len(self.word_to_ix)
        self.refs = info["refs"]
        self.images = info["images"]
        self.anns = info["anns"]
        self.sentences = info["sentences"]
        self.Refs = {r["ref_id"]: r for r in self.refs}
        self.Images = {i["image_id"]: i for i in self.images}
        self.sent_to_h5 = {s["sent_id"]: s["h5_id"] for s in self.sentences}
        # the attribute vocabulary (a prepro run with att_json)
        self.att_to_ix: Dict[str, int] = info.get("att_to_ix", {})
        self.ix_to_att = {i: w for w, i in self.att_to_ix.items()}

        if isinstance(data_h5, str):
            import h5py
            with h5py.File(data_h5, "r") as f:
                data_h5 = f["labels"][...]
        if data_h5 is None:
            self.labels = None
        else:
            self.labels = np.asarray(data_h5, np.int32)
            if self.labels.shape[0] != len(self.sentences):
                raise ValueError("label rows must match the sentence count")

    @property
    def max_length(self) -> int:
        return self.labels.shape[1]

    def fetch_seq(self, sent_id) -> np.ndarray:
        return self.labels[self.sent_to_h5[sent_id]]

    def decode_labels(self, labels: np.ndarray) -> List[str]:
        """(N, L) token ids -> N sentences, the 0s left out."""
        return [" ".join(self.ix_to_word[int(i)] for i in row if int(i) != 0)
                for row in labels]

    def att_multihot(self, ref_id) -> np.ndarray:
        """(len(att_to_ix),) f32 multi-hot of a ref's attribute words."""
        out = np.zeros((len(self.att_to_ix),), np.float32)
        for w in self.Refs[ref_id].get("att_wds", []):
            if w in self.att_to_ix:
                out[self.att_to_ix[w]] = 1.0
        return out


class GtBatchLoader(Loader):
    """Fixed-canvas batches over the (image, ref, sentence) structure."""

    def __init__(self, data_json: Union[str, Dict],
                 data_h5: Union[str, np.ndarray], cfg: Config,
                 image_dir: Optional[str] = None, seed: int = 3,
                 read_image: Optional[Callable[[str], np.ndarray]] = None):
        super().__init__(data_json, data_h5)
        self.cfg = cfg
        self.image_dir = image_dir or cfg.data.image_dir
        self.read_image = read_image or _cv2_imread
        self.rng = np.random.RandomState(seed)

        # split -> ids of the images that have refs in it
        self.split_ix: Dict[str, List[int]] = {}
        for img in self.images:
            splits = {self.Refs[rid]["split"] for rid in img["ref_ids"]}
            for sp in splits:
                self.split_ix.setdefault(sp, []).append(img["image_id"])
        self.iterators = {sp: 0 for sp in self.split_ix}
        self.perm = {sp: self.rng.permutation(len(v))
                     for sp, v in self.split_ix.items()}

    # ---- iterator state ----

    def state_dict(self) -> Dict:
        return {"iterators": dict(self.iterators),
                "perm": {k: v.copy() for k, v in self.perm.items()},
                "rng_state": self.rng.get_state()}

    def load_state_dict(self, state: Dict):
        self.iterators.update(state["iterators"])
        for k, v in state["perm"].items():
            self.perm[k] = np.asarray(v)
        self.rng.set_state(state["rng_state"])

    def reset_iterator(self, split: str):
        self.iterators[split] = 0

    # ---- images and masks ----

    def _image(self, img_rec: Dict) -> np.ndarray:
        path = os.path.join(self.image_dir, img_rec["file_name"])
        im = self.read_image(path)
        if im is None:
            raise FileNotFoundError(path)
        return im

    def _scale_for(self, h: int, w: int) -> float:
        t, d = self.cfg.train, self.cfg.data
        scale = min(float(t.scales[0]) / min(h, w),
                    float(t.max_size) / max(h, w))
        return min(scale, d.canvas_h / h, d.canvas_w / w)

    def _image_to_canvas(self, im: np.ndarray
                         ) -> Tuple[np.ndarray, float, int, int]:
        d = self.cfg.data
        scale = self._scale_for(*im.shape[:2])
        resized = resize_linear(im, scale)
        sh, sw = resized.shape[:2]
        if d.wire_uint8_images:
            # raw BGR (the model subtracts the means on the device); the
            # padding is the rounded means, ~0 once subtracted
            canvas = np.empty((d.canvas_h, d.canvas_w, 3), np.uint8)
            canvas[:] = np.round(d.pixel_means_bgr).astype(np.uint8)
            canvas[:sh, :sw] = np.clip(np.round(resized), 0, 255)
            return canvas, scale, sh, sw
        resized -= np.asarray(d.pixel_means_bgr, np.float32)
        canvas = np.zeros((d.canvas_h, d.canvas_w, 3), np.float32)
        canvas[:sh, :sw] = resized
        return canvas, scale, sh, sw

    def _ref_mask(self, rid: int, sh: int, sw: int) -> np.ndarray:
        """A ref's GT mask nearest-resized to the scaled extent, on the
        canvas: exact-rational nearest, or with cfg.data.
        reference_exact_masks the reference's scipy imresize (Pillow
        NEAREST, gt_mrcn_loader.py:210)."""
        d = self.cfg.data
        rle = self.Refs[rid]["rle"]
        if d.reference_exact_masks:
            out = np.zeros((d.canvas_h, d.canvas_w), np.uint8)
            out[:sh, :sw] = scipy_imresize(rle_codec.decode(rle), (sh, sw),
                                           "nearest")
            return out
        return rle_codec.decode_resize_batch([rle], d.canvas_h, d.canvas_w,
                                             sh, sw)[0]

    # ---- batching ----

    def _next_image_ids(self, split: str, n: int) -> Tuple[List[int], bool]:
        ids, wrapped = [], False
        order = self.split_ix[split]
        for _ in range(n):
            ri = self.iterators[split]
            if ri >= len(order):
                self.perm[split] = self.rng.permutation(len(order))
                self.iterators[split] = 0
                ri = 0
                wrapped = True
            ids.append(order[self.perm[split][ri]])
            self.iterators[split] = ri + 1
        return ids, wrapped

    def get_batch(self, split: str = "train",
                  num_images: Optional[int] = None,
                  num_expr: Optional[int] = None,
                  num_shards: Optional[int] = None,
                  shard: Optional[int] = None) -> Dict[str, np.ndarray]:
        """A fixed-shape training batch.

        num_shards 1 (default cfg.parallel.num_data): one block of I
        images x E expressions. num_shards n: n self-contained blocks, as
        the JAX loader draws them (each block's `img_idx` indexes its own
        I images), concatenated along axis 0, or with `shard` r only
        block r (a data-parallel rank's). Every call makes the random
        draws of all n blocks in order, so the loaders of all ranks stay
        in step; only the blocks returned decode their images and masks.
        `wrapped` is whether any block's draw wrapped an epoch."""
        num_shards = num_shards or self.cfg.parallel.num_data
        if num_shards <= 1:
            return self._build_block(self._plan_block(
                split, num_images, num_expr))
        if shard is not None and not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} outside 0..{num_shards - 1}")
        plans = [self._plan_block(split, num_images, num_expr)
                 for _ in range(num_shards)]
        wrapped = any(p[1] for p in plans)
        if shard is not None:
            out = self._build_block(plans[shard])
            out["wrapped"] = wrapped
            return out
        blocks = [self._build_block(p) for p in plans]
        out = {k: np.concatenate([b[k] for b in blocks], axis=0)
               for k in blocks[0] if k != "wrapped"}
        out["wrapped"] = wrapped
        return out

    def _plan_block(self, split: str, num_images: Optional[int],
                    num_expr: Optional[int]) -> Tuple:
        """A block's random draws (its images, then E expressions drawn
        uniformly from those images' (ref, sentence) pool, with
        replacement when it holds fewer than E), as the JAX loader draws
        them; no image is read. Returns (image ids, wrapped, draws)."""
        t = self.cfg.train
        num_images = num_images or t.images_per_batch
        num_expr = num_expr or t.expressions_per_batch
        img_ids, wrapped = self._next_image_ids(split, num_images)
        pool = []                                 # (image slot, ref, sentence)
        for li, iid in enumerate(img_ids):
            for rid in self.Images[iid]["ref_ids"]:
                ref = self.Refs[rid]
                if split and ref["split"] != split:
                    continue
                for sid in ref["sent_ids"]:
                    pool.append((li, rid, sid))
        if not pool:
            raise ValueError(f"no expressions for images {img_ids} in split "
                             f"{split}")
        take = [pool[i] for i in
                self.rng.choice(len(pool), size=num_expr,
                                replace=len(pool) < num_expr)] \
            if len(pool) != num_expr else pool
        return img_ids, wrapped, take

    def _build_block(self, plan: Tuple) -> Dict[str, np.ndarray]:
        """A planned block's arrays: the canvases, boxes and masks."""
        d, m = self.cfg.data, self.cfg.model
        img_ids, wrapped, take = plan
        num_images, num_expr = len(img_ids), len(take)
        images = np.zeros((num_images, d.canvas_h, d.canvas_w, 3),
                          np.uint8 if d.wire_uint8_images else np.float32)
        im_hw = np.zeros((num_images, 2), np.float32)
        scales = np.zeros((num_images,), np.float32)
        extents = []
        for li, iid in enumerate(img_ids):
            canvas, scale, sh, sw = self._image_to_canvas(
                self._image(self.Images[iid]))
            images[li] = canvas
            im_hw[li] = (sh, sw)
            scales[li] = scale
            extents.append((sh, sw))

        img_idx = np.asarray([p[0] for p in take], np.int32)
        expr_uid = np.asarray([self.sent_to_h5[p[2]] for p in take], np.int32)
        labels = np.stack([self.fetch_seq(p[2]) for p in take])
        gt_boxes = np.zeros((num_expr, 5), np.float32)
        gt_masks = np.zeros((num_expr, d.canvas_h, d.canvas_w), np.uint8)
        for ei, (li, rid, _) in enumerate(take):
            ref = self.Refs[rid]
            box = xywh_to_xyxy(np.asarray(ref["box"], np.float32))
            gt_boxes[ei, :4] = box * scales[li]
            gt_boxes[ei, 4] = ref["category_id"]
            gt_masks[ei] = self._ref_mask(rid, *extents[li])

        if d.wire_packed_masks and d.canvas_w % 8 == 0:
            gt_masks = np.packbits(gt_masks > 0, axis=-1)
        batch = {"images": images, "im_hw": im_hw, "labels": labels,
                 "img_idx": img_idx, "expr_uid": expr_uid,
                 "gt_boxes": gt_boxes, "gt_masks": gt_masks,
                 "im_scales": scales, "wrapped": wrapped}
        if m.use_caption_loss:
            batch.update(caption_targets(labels))
        if m.use_attribute_head and self.att_to_ix:
            att_labels = np.stack([self.att_multihot(p[1]) for p in take])
            batch["att_labels"] = att_labels
            batch["att_valid"] = att_labels.sum(axis=1) > 0
        return batch

    def get_test_batch(self, split: str, max_sents: Optional[int] = None,
                       buckets: Optional[Tuple[int, ...]] = None
                       ) -> Dict[str, np.ndarray]:
        """One image with all its sentences of the split, padded to
        max_sents slots, or to the smallest of `buckets` that fits, with
        `sent_valid` (reference getTestBatch, gt_mrcn_loader.py:633).
        With cfg.data.wire_mask_bank, each ref's mask travels once:
        `gt_mask_bank` (R, Hc, Wc), R = S // 2 when the refs fit there,
        else S, and `mask_ref_idx` (S,) its row per sentence."""
        d = self.cfg.data
        img_ids, wrapped = self._next_image_ids(split, 1)
        rec = self.Images[img_ids[0]]
        canvas, scale, sh, sw = self._image_to_canvas(self._image(rec))

        triples = [(rid, sid) for rid in rec["ref_ids"]
                   if self.Refs[rid]["split"] == split
                   for sid in self.Refs[rid]["sent_ids"]]
        s_real = len(triples)
        if s_real == 0:
            raise ValueError(f"image {rec['image_id']} has no sentences in "
                             f"split {split}")
        if buckets:
            fitting = [b for b in sorted(buckets) if b >= s_real]
            s_pad = fitting[0] if fitting else max(buckets)
        else:
            s_pad = max_sents or s_real

        labels = np.zeros((s_pad, self.max_length), np.int32)
        gt_boxes = np.zeros((s_pad, 5), np.float32)
        sent_valid = np.zeros((s_pad,), bool)
        bank_rows: List[int] = []                 # ref id of each bank row
        row_of: Dict[int, int] = {}
        mask_ref_idx = np.zeros((s_pad,), np.int32)
        for i, (rid, sid) in enumerate(triples[:s_pad]):
            ref = self.Refs[rid]
            labels[i] = self.fetch_seq(sid)
            box = xywh_to_xyxy(np.asarray(ref["box"], np.float32))
            gt_boxes[i, :4] = box * scale
            gt_boxes[i, 4] = ref["category_id"]
            if rid not in row_of:
                row_of[rid] = len(bank_rows)
                bank_rows.append(rid)
            mask_ref_idx[i] = row_of[rid]
            sent_valid[i] = True

        batch = {"images": canvas[None],
                 "im_hw": np.asarray([[sh, sw]], np.float32),
                 "labels": labels, "gt_boxes": gt_boxes,
                 "sent_valid": sent_valid, "im_scale": scale,
                 "wrapped": wrapped, "image_id": rec["image_id"]}
        if d.wire_mask_bank:
            half = max(1, s_pad // 2)
            r_pad = half if len(bank_rows) <= half else s_pad
            bank = np.zeros((r_pad, d.canvas_h, d.canvas_w), np.uint8)
            for row, rid in enumerate(bank_rows):
                bank[row] = self._ref_mask(rid, sh, sw)
            batch["gt_mask_bank"] = bank
            batch["mask_ref_idx"] = mask_ref_idx
        else:
            gt_masks = np.zeros((s_pad, d.canvas_h, d.canvas_w), np.uint8)
            for i, (rid, _) in enumerate(triples[:s_pad]):
                gt_masks[i] = self._ref_mask(rid, sh, sw)
            batch["gt_masks"] = gt_masks
        return batch

    def iter_attribute_batches(self, split: str, max_refs: int = 16):
        """Per image of the split, in the test iteration's order: the
        canvas and the scaled GT boxes (padded to `max_refs`) of its refs
        in the split that carry attribute words, with `ref_valid`,
        `ref_ids` and their `gd_att_wds` (reference getAttributeBatch,
        eval_easy_utils.py:41-80); images without such refs are
        skipped."""
        self.reset_iterator(split)
        for _ in range(len(self.split_ix[split])):
            img_ids, _ = self._next_image_ids(split, 1)
            rec = self.Images[img_ids[0]]
            rids = [rid for rid in rec["ref_ids"]
                    if self.Refs[rid]["split"] == split
                    and self.Refs[rid].get("att_wds")]
            if not rids:
                continue
            canvas, scale, _, _ = self._image_to_canvas(self._image(rec))
            rids = rids[:max_refs]
            boxes = np.zeros((max_refs, 4), np.float32)
            valid = np.zeros((max_refs,), bool)
            for i, rid in enumerate(rids):
                boxes[i] = xywh_to_xyxy(
                    np.asarray(self.Refs[rid]["box"], np.float32)) * scale
                valid[i] = True
            yield {"images": canvas[None], "boxes": boxes[None],
                   "ref_valid": valid, "ref_ids": rids,
                   "gd_att_wds": [self.Refs[rid]["att_wds"]
                                  for rid in rids]}

    def iter_test_batches(self, split: str, max_sents: int = 32,
                          buckets: Optional[Tuple[int, ...]] = None):
        """Every image of the split, once."""
        self.reset_iterator(split)
        for _ in range(len(self.split_ix[split])):
            yield self.get_test_batch(split, max_sents=max_sents,
                                      buckets=buckets)


class CycleBatchLoader(GtBatchLoader):
    """Caption targets always on (reference CycleLoader)."""

    def get_batch(self, *a, **kw):
        batch = super().get_batch(*a, **kw)
        if "cap_labels" not in batch:
            batch.update(caption_targets(batch["labels"]))
        return batch
