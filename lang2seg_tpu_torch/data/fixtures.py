"""Mini REFER and COCO data drawn from a seed, for tests, smoke runs and
card tests; no JPEG is written (the card's machine has no encoder), the
images come from the `read_image` callable each function returns.

* `mini_refer_split`: a prepro'd REFER split in memory, without files,
  cv2 or h5py: what `data/loader.py::GtBatchLoader` takes, a `data.json`
  dict, the (N, L) int32 label array and `read_image`. Each ref is a box
  with an elliptic mask inside it (RLE-encoded by `data/rle.py`) and
  `sents_per_ref` sentences of 2 to L tokens.
* `write_mini_refer`: the raw trees that the offline tools read, the
  port's counterpart of `lang2seg_tpu/data/fixtures.py::make_mini_refer`:
  `<root>/<dataset>/refs(<split_by>).p` + `instances.json` (for
  `data/refer.py::REFER` and `data/prepro.py`) and a COCO-style
  `<root>/coco/instances_train2014.json` over the same images and a few
  without refs (for `data/coco_detection.py`).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from . import rle

WORDS = ("the", "left", "right", "big", "small", "red", "blue", "person",
         "dog", "chair", "on", "next", "to", "front", "behind", "man",
         "woman", "car", "white", "black")
CATEGORIES = (1, 18, 62)
CATEGORY_NAMES = {1: "person", 18: "dog", 62: "chair"}


def _image(rng, h: int, w: int) -> np.ndarray:
    """A BGR uint8 image: a smooth gradient, a few flat blocks and
    noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = rng.uniform(40, 200, 3)[None, None] + \
        (yy[..., None] / h * rng.uniform(-60, 60, 3)
         + xx[..., None] / w * rng.uniform(-60, 60, 3))
    for _ in range(4):
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        base[y0:y0 + rng.randint(h // 8, h // 2),
             x0:x0 + rng.randint(w // 8, w // 2)] = rng.uniform(0, 255, 3)
    base += rng.normal(0, 8, base.shape)
    return np.clip(np.round(base), 0, 255).astype(np.uint8)


def mini_refer_split(image_hw: Sequence[Tuple[int, int]],
                     refs_per_image: Sequence[int],
                     splits: Sequence[str], sents_per_ref: int = 3,
                     max_len: int = 10, seed: int = 0
                     ) -> Tuple[Dict, np.ndarray, Callable]:
    """One image per entry of `image_hw` (h, w), with refs_per_image[i]
    refs in splits[i]. Returns (data_json dict, labels, read_image)."""
    rng = np.random.RandomState(seed)
    vocab = ["<PAD>", "<UNK>", "<BOS>", "<EOS>"] + list(WORDS)
    word_to_ix = {w: i for i, w in enumerate(vocab)}
    images, anns, refs, sentences, labels, pixels = [], [], [], [], [], {}
    ann_id = ref_id = sent_id = 1
    for i, ((h, w), n_refs, split) in enumerate(zip(image_hw, refs_per_image,
                                                    splits)):
        image_id = 1000 + i
        fname = f"COCO_train2014_{image_id:012d}.jpg"
        pixels[fname] = _image(rng, h, w)
        rec = {"image_id": image_id, "file_name": fname, "width": w,
               "height": h, "ref_ids": [], "ann_ids": []}
        for _ in range(n_refs):
            bw = float(rng.randint(w // 6, w // 2))
            bh = float(rng.randint(h // 6, h // 2))
            x = float(rng.randint(0, int(w - bw)))
            y = float(rng.randint(0, int(h - bh)))
            yy, xx = np.mgrid[0:h, 0:w]
            mask = ((((xx - (x + bw / 2)) / (bw / 2)) ** 2
                     + ((yy - (y + bh / 2)) / (bh / 2)) ** 2) <= 1.0
                    ).astype(np.uint8)
            cat = int(rng.choice(CATEGORIES))
            anns.append({"ann_id": ann_id, "category_id": cat,
                         "image_id": image_id, "box": [x, y, bw, bh]})
            sids = []
            for _ in range(sents_per_ref):
                toks = [WORDS[t] for t in
                        rng.randint(0, len(WORDS), rng.randint(2, 11))]
                row = np.zeros(max_len, np.int32)
                row[:len(toks)] = [word_to_ix[t] for t in toks]
                sentences.append({"sent_id": sent_id, "tokens": toks,
                                  "h5_id": len(labels)})
                labels.append(row)
                sids.append(sent_id)
                sent_id += 1
            code = rle.encode(mask)
            refs.append({"ref_id": ref_id, "ann_id": ann_id,
                         "image_id": image_id, "split": split,
                         "category_id": cat, "box": [x, y, bw, bh],
                         "rle": {"size": code["size"],
                                 "counts": code["counts"].decode("ascii")},
                         "sent_ids": sids})
            rec["ref_ids"].append(ref_id)
            rec["ann_ids"].append(ann_id)
            ann_id += 1
            ref_id += 1
        images.append(rec)
    info = {"images": images, "anns": anns, "refs": refs,
            "sentences": sentences, "word_to_ix": word_to_ix,
            "ix_to_word": {str(i): w for i, w in enumerate(vocab)}}

    def read_image(path: str) -> np.ndarray:
        return pixels.get(os.path.basename(path))

    return info, np.stack(labels), read_image


def _polygon(rng, x: float, y: float, bw: float, bh: float) -> List[float]:
    """A star-shaped polygon of 6 to 11 float vertices inside the box."""
    n = int(rng.randint(6, 12))
    ang = np.sort(rng.uniform(0.0, 2.0 * np.pi, n))
    rad = rng.uniform(0.55, 1.0, n)
    xs = x + bw / 2 + (bw / 2) * rad * np.cos(ang)
    ys = y + bh / 2 + (bh / 2) * rad * np.sin(ang)
    return [float(v) for v in np.stack([xs, ys], 1).reshape(-1)]


def _annotation(rng, ann_id: int, image_id: int, h: int, w: int,
                kind: str) -> Dict:
    """A COCO annotation of `kind`: 'poly' (one or two polygons), 'rle'
    (an uncompressed-RLE ellipse), 'crowd' (the same, iscrowd 1) or
    'degenerate' (a polygon whose box is under a pixel wide)."""
    cat = int(rng.choice(CATEGORIES))
    bw = float(rng.randint(w // 6, w // 2))
    bh = float(rng.randint(h // 6, h // 2))
    x = float(rng.uniform(0, w - bw - 1))
    y = float(rng.uniform(0, h - bh - 1))
    if kind == "degenerate":
        segm = [[x, y, x + 0.5, y, x + 0.5, y + bh, x, y + bh]]
        box = [x, y, 0.5, bh]
    elif kind == "poly":
        segm = [_polygon(rng, x, y, bw, bh)]
        if rng.rand() < 0.5:                  # a second, disjoint part
            segm.append(_polygon(rng, x, y + bh * 0.6, bw * 0.3, bh * 0.3))
        xy = np.concatenate([np.reshape(p, (-1, 2)) for p in segm])
        lo, hi = xy.min(0), xy.max(0)
        box = [float(lo[0]), float(lo[1]), float(hi[0] - lo[0]),
               float(hi[1] - lo[1])]
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        mask = ((((xx - (x + bw / 2)) / (bw / 2)) ** 2
                 + ((yy - (y + bh / 2)) / (bh / 2)) ** 2) <= 1.0
                ).astype(np.uint8)
        counts = rle.str_decode(rle.encode(mask)["counts"])
        segm = {"size": [h, w], "counts": [int(c) for c in counts]}
        ys, xs = np.nonzero(mask)
        box = [float(xs.min()), float(ys.min()),
               float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)]
    return {"id": ann_id, "image_id": image_id, "category_id": cat,
            "bbox": box, "segmentation": segm, "area": box[2] * box[3],
            "iscrowd": int(kind == "crowd")}


def write_mini_refer(root: str, image_hw: Sequence[Tuple[int, int]],
                     refs_per_image: Sequence[int], splits: Sequence[str],
                     extra_image_hw: Sequence[Tuple[int, int]] = (),
                     sents_per_ref: int = 2, dataset: str = "refcoco",
                     split_by: str = "unc",
                     seed: int = 0) -> Tuple[str, Callable]:
    """Write the raw REFER tree of one image per entry of `image_hw` (h, w),
    refs_per_image[i] refs in splits[i], and the COCO-style instances of
    those images and of one more image per entry of `extra_image_hw`.

    Each image has 2 to 8 kept annotations (polygons of one or two parts;
    the first image's first annotation is an uncompressed RLE, with a ref
    on it); the second image also carries a crowd annotation and the third
    a degenerate (w < 1) box, which refs never point at and the detection
    loader drops. Each ref has `sents_per_ref` sentences of 2 to 10 tokens
    (the prepro's refcoco label length). Returns (the COCO instances
    path, read_image)."""
    rng = np.random.RandomState(seed)
    ddir = os.path.join(root, dataset)
    os.makedirs(ddir, exist_ok=True)
    os.makedirs(os.path.join(root, "coco"), exist_ok=True)
    categories = [{"id": c, "name": CATEGORY_NAMES[c]} for c in CATEGORIES]
    images, anns, refs, pixels = [], [], [], {}
    ann_id = ref_id = sent_id = 1
    all_hw = list(image_hw) + list(extra_image_hw)
    for i, (h, w) in enumerate(all_hw):
        image_id = 1000 + i
        fname = f"COCO_train2014_{image_id:012d}.jpg"
        pixels[fname] = _image(rng, h, w)
        images.append({"id": image_id, "file_name": fname, "width": w,
                       "height": h})
        n_refs = refs_per_image[i] if i < len(image_hw) else 0
        kinds = ["poly"] * max(n_refs, int(rng.randint(2, 9)))
        if i == 0:
            kinds[0] = "rle"
        kinds += ["crowd"] * (i == 1) + ["degenerate"] * (i == 2)
        first = len(anns)
        for kind in kinds:
            anns.append(_annotation(rng, ann_id, image_id, h, w, kind))
            ann_id += 1
        for a in anns[first:first + n_refs]:
            sents, sids = [], []
            for _ in range(sents_per_ref):
                toks = [WORDS[t] for t in
                        rng.randint(0, len(WORDS), rng.randint(2, 11))]
                sents.append({"sent_id": sent_id, "tokens": toks,
                              "raw": " ".join(toks), "sent": " ".join(toks)})
                sids.append(sent_id)
                sent_id += 1
            refs.append({"ref_id": ref_id, "ann_id": a["id"],
                         "image_id": image_id,
                         "category_id": a["category_id"], "split": splits[i],
                         "sent_ids": sids, "sentences": sents})
            ref_id += 1

    refer_ids = {im["id"] for im in images[:len(image_hw)]}
    # refs files of the reference are Python 2 pickles (protocol 2)
    with open(os.path.join(ddir, f"refs({split_by}).p"), "wb") as f:
        pickle.dump(refs, f, protocol=2)
    with open(os.path.join(ddir, "instances.json"), "w") as f:
        json.dump({"images": images[:len(image_hw)],
                   "annotations": [a for a in anns
                                   if a["image_id"] in refer_ids],
                   "categories": categories}, f)
    coco_path = os.path.join(root, "coco", "instances_train2014.json")
    with open(coco_path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": categories}, f)

    def read_image(path: str) -> np.ndarray:
        return pixels.get(os.path.basename(path))

    return coco_path, read_image
