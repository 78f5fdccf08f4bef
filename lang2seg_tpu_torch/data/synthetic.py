"""Synthetic fixed-shape batches for tests and benchmarks (no dataset
download required); the port's own copy of `lang2seg_tpu/data/
synthetic.py`, with the same draws for the same seed. Mirrors the blob
layout of the real loader (lib/loaders/gt_mrcn_loader.py getBatch:
mean-subtracted image canvas, scaled GT boxes + category, canvas-sized
binary masks, padded token ids)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..config import Config


def synthetic_batch(cfg: Config, num_images: int, num_expr: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    d, m = cfg.data, cfg.model
    h, w = d.canvas_h, d.canvas_w

    images = rng.randn(num_images, h, w, 3).astype(np.float32) * 30.0
    im_hw = np.stack([
        rng.uniform(h * 0.8, h, num_images),
        rng.uniform(w * 0.8, w, num_images)], axis=1).astype(np.float32)

    img_idx = rng.randint(0, num_images, num_expr).astype(np.int32)
    labels = rng.randint(1, m.vocab_size, (num_expr, d.max_len)).astype(np.int32)
    # variable lengths with zero padding (PAD=0)
    lengths = rng.randint(2, d.max_len + 1, num_expr)
    for i, ln in enumerate(lengths):
        labels[i, ln:] = 0

    gt_boxes = np.zeros((num_expr, 5), np.float32)
    gt_masks = np.zeros((num_expr, h, w), np.uint8)
    for i in range(num_expr):
        ih, iw = im_hw[img_idx[i]]
        x1 = rng.uniform(0, iw * 0.5)
        y1 = rng.uniform(0, ih * 0.5)
        bw = rng.uniform(iw * 0.2, iw * 0.45)
        bh = rng.uniform(ih * 0.2, ih * 0.45)
        x2 = min(x1 + bw, iw - 1)
        y2 = min(y1 + bh, ih - 1)
        cls = rng.randint(1, m.num_classes)
        gt_boxes[i] = [x1, y1, x2, y2, cls]
        gt_masks[i, int(y1):int(y2) + 1, int(x1):int(x2) + 1] = 1

    batch = {"images": images, "im_hw": im_hw, "labels": labels,
             "img_idx": img_idx, "gt_boxes": gt_boxes, "gt_masks": gt_masks}
    if m.use_caption_loss:
        t = m.cap_seq_length + 2
        cap = np.zeros((num_expr, t), np.int32)
        ln = min(d.max_len, t - 2)
        cap[:, 1:ln + 1] = labels[:, :ln]
        masks = (cap != 0).astype(np.float32)
        masks[:, 0] = 1.0  # BOS slot
        batch["cap_labels"] = cap
        batch["cap_masks"] = masks
    return batch


def uint8_canvas(cfg: Config, images: np.ndarray) -> np.ndarray:
    """Mean-subtracted f32 canvases as the raw uint8 BGR wire format (the
    model subtracts the pixel means on the device)."""
    means = np.asarray(cfg.data.pixel_means_bgr, np.float32)
    return np.clip(np.round(images + means), 0, 255).astype(np.uint8)


def to_wire(cfg: Config, batch: Dict[str, np.ndarray]
            ) -> Dict[str, np.ndarray]:
    """A training batch in the wire formats that cfg.data selects, as the
    JAX package's loader sends them (`data/loader.py`): the uint8 canvas
    (wire_uint8_images) and GT masks bit-packed MSB-first along the width
    (wire_packed_masks, when the canvas width is a multiple of 8)."""
    out = dict(batch)
    if cfg.data.wire_uint8_images:
        out["images"] = uint8_canvas(cfg, batch["images"])
    if cfg.data.wire_packed_masks and batch["gt_masks"].shape[-1] % 8 == 0:
        out["gt_masks"] = np.packbits(batch["gt_masks"] > 0, axis=-1)
    return out


class FixedBatchLoader:
    """A loader over a fixed list of batches, taken in turn whatever the
    split: the `Trainer`'s `get_batch` and iterator state for synthetic
    batches (benchmarks, tests, smoke runs)."""

    def __init__(self, batches):
        self.batches = list(batches)
        self.position = 0

    def get_batch(self, split: str = "train") -> Dict[str, np.ndarray]:
        batch = self.batches[self.position % len(self.batches)]
        self.position += 1
        return batch

    def state_dict(self) -> Dict:
        return {"position": self.position}

    def load_state_dict(self, state: Dict):
        self.position = state["position"]


def synthetic_test_batch(cfg: Config, num_expr: int,
                         seed: int = 0) -> Dict[str, np.ndarray]:
    b = synthetic_batch(cfg, 1, num_expr, seed)
    return {"images": b["images"], "im_hw": b["im_hw"],
            "labels": b["labels"]}


def synthetic_eval_request(cfg: Config, num_expr: int, seed: int = 0,
                           im_scale: float = 1.0) -> Dict[str, np.ndarray]:
    """One `Evaluator.eval_image` request in the uint8 wire format: the
    raw BGR canvas (the model subtracts the pixel means on the device),
    canvas-sized GT masks and the image's scale."""
    b = synthetic_batch(cfg, 1, num_expr, seed)
    return {"images": uint8_canvas(cfg, b["images"]), "im_hw": b["im_hw"],
            "labels": b["labels"], "gt_boxes": b["gt_boxes"], "gt_masks": b["gt_masks"],
            "im_scale": np.float32(im_scale)}


def synthetic_learnable_set(cfg: Config, num_images: int = 4,
                            seed: int = 0):
    """A fixed, visually learnable referring set for the closed-loop
    learning proof, with the draws of the JAX package's
    `synthetic_learnable_set` (`data/synthetic.py:68-145`).

    Each image: a low-noise background and two non-overlapping rectangles
    with distinct channel signatures ("colours"), one in each half. Each
    rectangle has one expression [colour word, noun] whose first token
    names the colour; its GT box and mask are the rectangle, its class
    the colour's index. Extents sit in the anchors' range (the smallest
    anchor is 64 px).

    Returns (train_batch, eval_batches): a loader-format batch of
    I = num_images mean-subtracted f32 images and E = 2 I expressions,
    and one `Evaluator.eval_image` batch per image (im_scale 1, im_hw the
    full canvas)."""
    rng = np.random.RandomState(seed)
    d = cfg.data
    h, w = d.canvas_h, d.canvas_w
    colors = np.asarray([[110.0, -70.0, -70.0],
                         [-70.0, 110.0, -70.0]], np.float32)

    images = (rng.randn(num_images, h, w, 3) * 5.0).astype(np.float32)
    im_hw = np.tile(np.asarray([[h, w]], np.float32), (num_images, 1))
    boxes_all, masks_all, labels_all, idx_all = [], [], [], []
    for i in range(num_images):
        for c in range(2):
            x_lo = 2 + c * (w // 2)
            x1 = rng.randint(x_lo, x_lo + w // 8)
            y1 = rng.randint(2, h // 6)
            bw = rng.randint(int(w * 0.3), int(w * 0.46))
            bh = rng.randint(int(h * 0.55), int(h * 0.85))
            x2 = min(x1 + bw, x_lo + w // 2 - 4, w - 2)
            y2 = min(y1 + bh, h - 2)
            images[i, y1:y2 + 1, x1:x2 + 1] = colors[c] + \
                rng.randn(y2 - y1 + 1, x2 - x1 + 1, 3).astype(np.float32) * 3
            boxes_all.append([x1, y1, x2, y2, c + 1])
            mask = np.zeros((h, w), np.uint8)
            mask[y1:y2 + 1, x1:x2 + 1] = 1
            masks_all.append(mask)
            lab = np.zeros(d.max_len, np.int32)
            lab[0], lab[1] = c + 1, 3
            labels_all.append(lab)
            idx_all.append(i)

    train_batch = {
        "images": images,
        "im_hw": im_hw,
        "labels": np.stack(labels_all),
        "img_idx": np.asarray(idx_all, np.int32),
        "gt_boxes": np.asarray(boxes_all, np.float32),
        "gt_masks": np.stack(masks_all),
        "expr_uid": np.arange(len(idx_all), dtype=np.int32),
    }
    eval_batches = []
    for i in range(num_images):
        sl = [j for j, ii in enumerate(idx_all) if ii == i]
        eval_batches.append({
            "images": images[i:i + 1],
            "im_hw": im_hw[i:i + 1],
            "labels": train_batch["labels"][sl],
            "gt_boxes": train_batch["gt_boxes"][sl],
            "gt_masks": train_batch["gt_masks"][sl],
            "im_scale": np.float32(1.0),
        })
    return train_batch, eval_batches
