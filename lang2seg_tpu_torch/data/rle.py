"""COCO RLE mask codec, NumPy only: the port's copy of the NumPy path of
`lang2seg_tpu/data/rle.py` (the public COCO RLE format: column-major
alternating-run counts; the compressed-string form packs 6-bit groups
offset by 48, with delta coding from index 2). No native library.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

RLE = Dict  # {'size': [h, w], 'counts': bytes | str | list}


def _counts_from_obj(rle: RLE) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (list, np.ndarray)):
        return np.asarray(c, dtype=np.uint32)
    if isinstance(c, str):
        c = c.encode("ascii")
    return str_decode(c)


def str_decode(s: bytes) -> np.ndarray:
    """Compressed RLE string -> uint32 counts."""
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 1:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, dtype=np.uint32)


def str_encode(counts: np.ndarray) -> bytes:
    """uint32 counts -> compressed RLE string."""
    counts = np.asarray(counts, dtype=np.uint32)
    chunks = []
    for i, c in enumerate(counts.tolist()):
        x = c - (int(counts[i - 2]) if i > 1 else 0)
        more = True
        while more:
            d = x & 0x1F
            x >>= 5
            more = (x != -1) if (d & 0x10) else (x != 0)
            if more:
                d |= 0x20
            chunks.append(d + 48)
    return bytes(chunks)


def decode(rle: Union[RLE, List[RLE]]) -> np.ndarray:
    """RLE(s) -> (h, w) or (h, w, n) uint8 mask."""
    if isinstance(rle, list):
        return np.stack([decode(r) for r in rle], axis=-1)
    h, w = rle["size"]
    counts = _counts_from_obj(rle)
    total = h * w
    vals = np.arange(len(counts), dtype=np.uint8) % 2
    flat = np.repeat(vals, counts)
    if flat.size < total:
        flat = np.concatenate([flat, np.zeros(total - flat.size, np.uint8)])
    return flat[:total].reshape(w, h).T


def encode(mask: np.ndarray) -> RLE:
    """(h, w) {0, 1} uint8 -> RLE with compressed-string counts."""
    h, w = mask.shape
    flat = np.asfortranarray(mask).T.reshape(-1).astype(np.int8)
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).astype(np.uint32)
    if flat[0] == 1:
        counts = np.concatenate([[0], counts]).astype(np.uint32)
    return {"size": [h, w], "counts": str_encode(counts)}


def decode_resize_batch(rles: List[RLE], out_h: int, out_w: int,
                        res_h: int, res_w: int) -> np.ndarray:
    """Decode N same-size RLEs and nearest-resize each to (res_h, res_w)
    inside a zero-padded (out_h, out_w) canvas: pixel (y, x) reads source
    ((2y + 1) h // 2 res_h, (2x + 1) w // 2 res_w)."""
    num = len(rles)
    out = np.zeros((num, out_h, out_w), np.uint8)
    if num == 0:
        return out
    h, w = rles[0]["size"]
    ys = ((2 * np.arange(res_h) + 1) * h) // (2 * res_h)
    xs = ((2 * np.arange(res_w) + 1) * w) // (2 * res_w)
    for i, r in enumerate(rles):
        out[i, :res_h, :res_w] = decode(r)[np.ix_(ys, xs)]
    return out
