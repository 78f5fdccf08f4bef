"""COCO-style detection data for the Mask R-CNN pretraining stage (the
`pretrain` variant: no language). The port's copy of
`lang2seg_tpu/data/coco_detection.py`.

The reference's imdb stack (`pyutils/mask-faster-rcnn/lib/datasets/
{imdb,coco,refer_coco,factory}.py` + `lib/roi_data_layer/`) and its
`tools/make_coco_minus_refer_instances.py`:
  * `make_coco_minus_refer` writes the pretraining instances json: COCO
    train2014 without the images of the given REFER datasets' val and
    test splits;
  * `CocoDetectionLoader` batches a COCO instances.json: crowd and
    degenerate (w or h < 1) boxes dropped, an optional horizontal flip a
    draw, each image resized as `data/loader.py::GtBatchLoader` resizes it
    (the port's cv2 INTER_LINEAR rule, `resize_linear`) and placed
    top-left on the canvas, mean-subtracted f32; up to
    cfg.data.max_gt_per_image GT boxes (contiguous classes 1..K) and
    canvas masks an image. It takes the JAX loader's `np.random.
    RandomState` draws in the same order (the epoch permutation, the flip,
    then `choice` of M annotations when an image has more), so the same
    seed gives the same batches.

`read_image(path)` returns a BGR uint8 image (default `cv2.imread`,
imported on call).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from ..config import Config
from . import rle as rle_codec
from .loader import _cv2_imread, resize_linear


def make_coco_minus_refer(coco_instances_path: str, refer_roots: List[Tuple],
                          out_path: str) -> int:
    """Write `out_path`: the COCO instances of `coco_instances_path` minus
    every image that a ref of a val or test split (val, test, testA,
    testB) of the REFER datasets `refer_roots` ((data_root, dataset,
    split_by) triples) lies on. Returns the number of images kept.

    A split without refs excludes nothing. (The JAX package asks
    `getImgIds(ref_ids=[])` for it, which answers every image of the
    dataset, so for a dataset without one of the four splits,
    refcocog_umd among them, it drops the train images too.)"""
    from .refer import REFER

    excluded: Set[int] = set()
    for data_root, dataset, split_by in refer_roots:
        refer = REFER(data_root, dataset, split_by)
        for split in ("val", "test", "testA", "testB"):
            rids = refer.getRefIds(split=split)
            if rids:
                excluded |= set(refer.getImgIds(ref_ids=rids))

    with open(coco_instances_path) as f:
        inst = json.load(f)
    images = [im for im in inst["images"] if im["id"] not in excluded]
    keep_ids = {im["id"] for im in images}
    anns = [a for a in inst["annotations"] if a["image_id"] in keep_ids]
    out = {"images": images, "annotations": anns,
           "categories": inst["categories"]}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return len(images)


class CocoDetectionLoader:
    """Fixed-shape (I images x M GT) batches over a COCO instances.json."""

    def __init__(self, instances_path: str, image_dir: str, cfg: Config,
                 use_flipped: bool = True, seed: int = 3,
                 read_image: Optional[Callable[[str], np.ndarray]] = None):
        self.cfg = cfg
        self.image_dir = image_dir
        self.use_flipped = use_flipped
        self.read_image = read_image or _cv2_imread
        self.rng = np.random.RandomState(seed)

        with open(instances_path) as f:
            inst = json.load(f)
        self.images = {im["id"]: im for im in inst["images"]}
        # contiguous classes 1..K in category id order, as the imdb maps them
        cats = sorted(c["id"] for c in inst["categories"])
        self.cat_to_contig = {c: i + 1 for i, c in enumerate(cats)}
        self.imgToAnns: Dict[int, List] = {}
        for a in inst["annotations"]:
            if a.get("iscrowd", 0):
                continue
            _, _, w, h = a["bbox"]
            if w < 1 or h < 1:
                continue
            self.imgToAnns.setdefault(a["image_id"], []).append(a)
        # the images with at least one kept annotation
        self.ids = [i for i in self.images if self.imgToAnns.get(i)]
        self.perm = self.rng.permutation(len(self.ids))
        self.cursor = 0

    def state_dict(self) -> Dict:
        return {"perm": self.perm.copy(), "cursor": self.cursor,
                "rng_state": self.rng.get_state()}

    def load_state_dict(self, s: Dict):
        self.perm = np.asarray(s["perm"])
        self.cursor = s["cursor"]
        self.rng.set_state(s["rng_state"])

    def _ann_mask(self, ann, ih: int, iw: int) -> np.ndarray:
        segm = ann["segmentation"]
        if isinstance(segm, list):
            r = rle_codec.fr_poly(segm, ih, iw)
        elif isinstance(segm["counts"], list):
            r = rle_codec.fr_uncompressed(segm)
        else:
            r = segm
        return rle_codec.decode(r)

    def get_batch(self, num_images: Optional[int] = None
                  ) -> Dict[str, np.ndarray]:
        """I images (default cfg.train.images_per_batch), each its own
        example: images (I, Hc, Wc, 3) f32 mean-subtracted BGR, im_hw,
        img_idx = arange(I), gt_boxes (I, M, 5) [x1 y1 x2 y2 class] in
        canvas pixels, gt_valid (I, M), gt_masks (I, M, Hc, Wc) uint8 and
        `wrapped` (an epoch ended in this batch)."""
        d, t = self.cfg.data, self.cfg.train
        n = num_images or t.images_per_batch
        m = d.max_gt_per_image

        images = np.zeros((n, d.canvas_h, d.canvas_w, 3), np.float32)
        im_hw = np.zeros((n, 2), np.float32)
        gt_boxes = np.zeros((n, m, 5), np.float32)
        gt_valid = np.zeros((n, m), bool)
        gt_masks = np.zeros((n, m, d.canvas_h, d.canvas_w), np.uint8)
        wrapped = False

        for li in range(n):
            if self.cursor >= len(self.ids):
                self.perm = self.rng.permutation(len(self.ids))
                self.cursor = 0
                wrapped = True
            img_id = self.ids[self.perm[self.cursor]]
            self.cursor += 1
            rec = self.images[img_id]
            path = os.path.join(self.image_dir, rec["file_name"])
            im = self.read_image(path)
            if im is None:
                raise FileNotFoundError(path)
            flip = self.use_flipped and self.rng.rand() < 0.5
            if flip:
                im = im[:, ::-1]

            ih, iw = im.shape[:2]
            scale = min(float(t.scales[0]) / min(ih, iw),
                        float(t.max_size) / max(ih, iw),
                        d.canvas_h / ih, d.canvas_w / iw)
            resized = resize_linear(im, scale)
            resized -= np.asarray(d.pixel_means_bgr, np.float32)
            sh, sw = resized.shape[:2]
            images[li, :sh, :sw] = resized
            im_hw[li] = (sh, sw)

            anns = self.imgToAnns[img_id]
            if len(anns) > m:
                anns = [anns[i] for i in
                        self.rng.choice(len(anns), m, replace=False)]
            # nearest source pixel of each canvas pixel, exact in integers
            ys = ((2 * np.arange(sh) + 1) * ih) // (2 * sh)
            xs = ((2 * np.arange(sw) + 1) * iw) // (2 * sw)
            for gi, a in enumerate(anns):
                x, y, w_, h_ = a["bbox"]
                x1, y1 = x, y
                x2, y2 = x + w_ - 1, y + h_ - 1
                if flip:
                    x1, x2 = iw - 1 - x2, iw - 1 - x1
                gt_boxes[li, gi] = (x1 * scale, y1 * scale,
                                    x2 * scale, y2 * scale,
                                    self.cat_to_contig[a["category_id"]])
                gt_valid[li, gi] = True
                mask = self._ann_mask(a, ih, iw)
                if flip:
                    mask = mask[:, ::-1]
                gt_masks[li, gi, :sh, :sw] = mask[np.ix_(ys, xs)]

        return {"images": images, "im_hw": im_hw,
                "img_idx": np.arange(n, dtype=np.int32),
                "gt_boxes": gt_boxes, "gt_valid": gt_valid,
                "gt_masks": gt_masks, "wrapped": wrapped}
