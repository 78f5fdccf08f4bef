"""Inputs of every traffic mix, made from a seed: the one generator that
the files under `benchmark/traffic/` parametrize.

A copy of the measured package's synthetic batches (`synthetic_batch`,
`uint8_canvas`, `to_wire`, `synthetic_eval_request`) and of its eval mix
(`eval_batch`), kept here so that a change to the program cannot change
what the benchmark sends. A batch holds canvas-sized random images,
uniformly drawn scaled extents, expressions of 2 to `max_len` tokens,
one GT box and mask an expression, and caption targets when the
configuration trains a captioner. `sub_seed` turns the run's `--seed`
(any whole number) and a stream index into a 32-bit numpy seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def sub_seed(seed: int, *stream: int) -> int:
    return int(np.random.SeedSequence([int(seed) % (1 << 63), *stream])
               .generate_state(1)[0])


def batch(cfg, num_images: int, num_expr: int, seed: int
          ) -> Dict[str, np.ndarray]:
    """One training batch (mean-subtracted f32 images)."""
    rng = np.random.RandomState(seed)
    d, m = cfg["data"], cfg["model"]
    h, w = d["canvas_h"], d["canvas_w"]
    images = rng.randn(num_images, h, w, 3).astype(np.float32) * 30.0
    im_hw = np.stack([rng.uniform(h * 0.8, h, num_images),
                      rng.uniform(w * 0.8, w, num_images)],
                     axis=1).astype(np.float32)
    img_idx = rng.randint(0, num_images, num_expr).astype(np.int32)
    labels = rng.randint(1, m["vocab_size"],
                         (num_expr, d["max_len"])).astype(np.int32)
    for i, ln in enumerate(rng.randint(2, d["max_len"] + 1, num_expr)):
        labels[i, ln:] = 0
    gt_boxes = np.zeros((num_expr, 5), np.float32)
    gt_masks = np.zeros((num_expr, h, w), np.uint8)
    for i in range(num_expr):
        ih, iw = im_hw[img_idx[i]]
        x1 = rng.uniform(0, iw * 0.5)
        y1 = rng.uniform(0, ih * 0.5)
        bw = rng.uniform(iw * 0.2, iw * 0.45)
        bh = rng.uniform(ih * 0.2, ih * 0.45)
        x2, y2 = min(x1 + bw, iw - 1), min(y1 + bh, ih - 1)
        gt_boxes[i] = [x1, y1, x2, y2, rng.randint(1, m["num_classes"])]
        gt_masks[i, int(y1):int(y2) + 1, int(x1):int(x2) + 1] = 1
    out = {"images": images, "im_hw": im_hw, "labels": labels,
           "img_idx": img_idx, "gt_boxes": gt_boxes, "gt_masks": gt_masks}
    if m["use_caption_loss"]:
        t = m["cap_seq_length"] + 2
        cap = np.zeros((num_expr, t), np.int32)
        ln = min(d["max_len"], t - 2)
        cap[:, 1:ln + 1] = labels[:, :ln]
        masks = (cap != 0).astype(np.float32)
        masks[:, 0] = 1.0
        out["cap_labels"], out["cap_masks"] = cap, masks
    return out


def uint8_canvas(cfg, images: np.ndarray) -> np.ndarray:
    means = np.asarray(cfg["data"]["pixel_means_bgr"], np.float32)
    return np.clip(np.round(images + means), 0, 255).astype(np.uint8)


def to_wire(cfg, b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The uint8 canvas and width-packed GT masks, as the loader sends
    them."""
    out = dict(b)
    out["images"] = uint8_canvas(cfg, b["images"])
    out["gt_masks"] = np.packbits(b["gt_masks"] > 0, axis=-1)
    return out


def train_ring(cfg, traffic: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """`traffic["ring"]` distinct wire batches of `images` x
    `expressions`."""
    return [to_wire(cfg, batch(cfg, traffic["images"],
                               traffic["expressions"], sub_seed(seed, 1, i)))
            for i in range(traffic["ring"])]


def _loader_canvas(cfg, b: Dict[str, np.ndarray]):
    """The uint8 canvas and masks as the loader writes an image: an
    integer scaled extent, the rounded pixel means beyond it and no mask
    pixel beyond it (the evaluator's extent-crop wire relies on it)."""
    hw = np.round(b["im_hw"]).astype(np.float32)
    sh, sw = int(hw[0, 0]), int(hw[0, 1])
    canvas = uint8_canvas(cfg, b["images"])
    means = np.round(np.asarray(cfg["data"]["pixel_means_bgr"])).astype(
        np.uint8)
    canvas[:, sh:] = means
    canvas[:, :, sw:] = means
    masks = b["gt_masks"]
    masks[:, sh:] = 0
    masks[:, :, sw:] = 0
    return hw, canvas, masks


def serve_request(cfg, num_expr: int, seed: int, im_scale: float
                  ) -> Dict[str, np.ndarray]:
    """One image's request on the uint8 wire as the loader makes it, with
    its GT boxes and canvas-sized masks and its scale."""
    b = batch(cfg, 1, num_expr, seed)
    hw, canvas, masks = _loader_canvas(cfg, b)
    return {"images": canvas, "im_hw": hw, "labels": b["labels"],
            "gt_boxes": b["gt_boxes"], "gt_masks": masks,
            "im_scale": np.float32(im_scale)}


def serve_ring(cfg, traffic: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    return [serve_request(cfg, traffic["expressions"], sub_seed(seed, 2, i),
                          traffic["im_scale"])
            for i in range(traffic["ring"])]


def eval_image(cfg, seed: int, n_real: int, buckets, im_scale: float
               ) -> Dict[str, np.ndarray]:
    """One image of `n_real` valid sentences padded to the smallest
    fitting bucket, on the loader's wire: the rounded pixel means beyond
    the integer scaled extent, GT boxes and masks shared by refs of 3
    sentences (the mask bank: S // 2 rows when the refs fit, else S)."""
    s_pad = min(b for b in buckets if b >= n_real)
    b = batch(cfg, 1, s_pad, seed)
    hw, canvas, masks = _loader_canvas(cfg, b)
    ref_of = np.arange(s_pad) // 3
    half = max(1, s_pad // 2)
    rows = half if ref_of[n_real - 1] + 1 <= half else s_pad
    ref_of = np.minimum(ref_of, rows - 1).astype(np.int32)
    bank = np.zeros((rows,) + masks.shape[1:], np.uint8)
    gt_boxes = b["gt_boxes"].copy()
    for i in range(s_pad):
        if i % 3 == 0:
            bank[ref_of[i]] = masks[i]
        gt_boxes[i] = b["gt_boxes"][(ref_of[i] * 3) % s_pad]
    return {"images": canvas, "im_hw": hw, "labels": b["labels"],
            "gt_boxes": gt_boxes, "im_scale": np.float32(im_scale),
            "sent_valid": np.arange(s_pad) < n_real,
            "gt_mask_bank": bank, "mask_ref_idx": ref_of}


def eval_mix(cfg, traffic: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """The mix's images: one of each count in `real_counts`."""
    return [eval_image(cfg, sub_seed(seed, 3, i), n, traffic["buckets"],
                       traffic["im_scale"])
            for i, n in enumerate(traffic["real_counts"])]
