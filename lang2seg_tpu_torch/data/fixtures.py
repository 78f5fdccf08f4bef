"""A mini REFER split built in memory, for smoke runs and card tests.

The port's counterpart of `lang2seg_tpu/data/fixtures.py::
make_mini_refer` + the prepro's output, without files, cv2 or h5py:
`mini_refer_split` returns what `data/loader.py::GtBatchLoader` takes,
a `data.json` dict, the (N, L) int32 label array and a `read_image`
callable over BGR uint8 images drawn from a seed. Each ref is a box
with an elliptic mask inside it (RLE-encoded by `data/rle.py`) and
`sents_per_ref` sentences of 2 to L tokens.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from . import rle

WORDS = ("the", "left", "right", "big", "small", "red", "blue", "person",
         "dog", "chair", "on", "next", "to", "front", "behind", "man",
         "woman", "car", "white", "black")
CATEGORIES = (1, 18, 62)


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
                        rng.randint(0, len(WORDS), rng.randint(2, max_len + 1))]
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
