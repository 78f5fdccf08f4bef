"""COCO RLE mask codec, NumPy only: the port's copy of the NumPy path of
`lang2seg_tpu/data/rle.py` (the public COCO RLE format: column-major
alternating-run counts; the compressed-string form packs 6-bit groups
offset by 48, with delta coding from index 2), with the reference
`mask.py` surface: decode, encode, merge, area, iou and frPyObjects
(`fr_poly` for polygons, bit-exact to maskApi's rasterizer by default;
`fr_uncompressed` for uncompressed counts). No native library.
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


def area(rle: RLE) -> int:
    """Foreground pixel count."""
    return int(_counts_from_obj(rle)[1::2].sum())


def merge(rles: List[RLE], intersect: bool = False) -> RLE:
    """Union (or intersection) of same-size RLEs, compressed."""
    if not rles:
        raise ValueError("merge: no RLE given")
    h, w = rles[0]["size"]
    acc = _counts_from_obj(rles[0])
    for r in rles[1:]:
        ma = decode({"size": [h, w], "counts": acc})
        mb = decode({"size": [h, w], "counts": _counts_from_obj(r)})
        m = (ma & mb) if intersect else (ma | mb)
        acc = _counts_from_obj(encode(m))
    return {"size": [h, w], "counts": str_encode(acc)}


def iou(a: RLE, b: RLE) -> float:
    inter = area(merge([a, b], intersect=True))
    uni = area(a) + area(b) - inter
    return inter / uni if uni else 0.0


def _poly_boundary_counts(xy: np.ndarray, h: int, w: int) -> np.ndarray:
    """One polygon (flat [x0,y0,x1,y1,...]) -> uint32 RLE counts,
    bit-exact to the COCO maskApi rasterization (the public spec the
    dataset's GT bits are defined by; reference
    pyutils/refer/external/maskApi.c:161-201 rleFrPoly): vertices are
    scaled 5x and rounded, every edge is densified to unit steps along
    its major axis, column-crossing points are mapped back to the pixel
    grid, and the sorted crossing positions toggle alternating runs in
    column-major order.

    Degenerate edges (repeated vertex after scaling) emit a point whose
    row value is never read: both of its neighbour pairs share the same
    column, so the crossing filter drops them (the C code computes a
    0/0 NaN there and relies on the same property)."""
    S = 5  # maskApi upsampling factor
    xy = np.asarray(xy, np.float64)
    px = np.trunc(S * xy[0::2] + 0.5).astype(np.int64)
    py = np.trunc(S * xy[1::2] + 0.5).astype(np.int64)
    px = np.append(px, px[0])
    py = np.append(py, py[0])
    us: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    for j in range(len(px) - 1):
        xa, xb = int(px[j]), int(px[j + 1])
        ya, yb = int(py[j]), int(py[j + 1])
        dx, dy = abs(xb - xa), abs(ya - yb)
        flip = (dx >= dy and xa > xb) or (dx < dy and ya > yb)
        if flip:
            xa, xb, ya, yb = xb, xa, yb, ya
        if dx >= dy:
            d = np.arange(dx + 1, dtype=np.int64)
            t = (dx - d) if flip else d
            u = t + xa
            if dx == 0:
                v = np.array([ya], np.int64)  # value never read
            else:
                v = np.trunc(ya + (yb - ya) / dx * t + 0.5).astype(np.int64)
        else:
            d = np.arange(dy + 1, dtype=np.int64)
            t = (dy - d) if flip else d
            v = t + ya
            u = np.trunc(xa + (xb - xa) / dy * t + 0.5).astype(np.int64)
        us.append(u)
        vs.append(v)
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # keep only points where the dense walk crosses a pixel-column
    # boundary; the crossing's pixel column must land exactly on the
    # integer grid after downsampling
    cur, prev = u[1:], u[:-1]
    xd = np.where(cur < prev, cur, cur - 1).astype(np.float64)
    xd = (xd + 0.5) / S - 0.5
    keep = (cur != prev) & (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    yd = np.minimum(v[1:], v[:-1]).astype(np.float64)
    yd = (yd + 0.5) / S - 0.5
    yd = np.ceil(np.clip(yd, 0.0, float(h)))
    bx = xd[keep].astype(np.int64)
    by = yd[keep].astype(np.int64)

    # sorted column-major toggle positions -> alternating run lengths;
    # a zero gap (double toggle at one position) cancels out and its
    # following gap folds into the previous run
    a = np.sort(bx * h + by)
    a = np.append(a, h * w)
    diffs = np.diff(a, prepend=0).astype(np.int64)
    counts = [int(diffs[0])]
    j = 1
    while j < len(diffs):
        if diffs[j] > 0:
            counts.append(int(diffs[j]))
            j += 1
        else:
            j += 1
            if j < len(diffs):
                counts[-1] += int(diffs[j])
                j += 1
    return np.asarray(counts, dtype=np.uint32)


def fr_poly(polys: List[List[float]], h: int, w: int,
            method: str = "maskapi") -> RLE:
    """Polygon(s) -> RLE (reference frPyObjects + merge for polygon
    input, utils/mask_utils.py:14-18). method='maskapi' (default) is
    bit-exact to the COCO maskApi rasterizer that defines the dataset's
    GT masks; method='cv2' fills with cv2.fillPoly, imported on call
    (boundary pixels differ; bound measured in tests/test_ref_exact.py)."""
    if method == "maskapi":
        rles = [{"size": [h, w],
                 "counts": str_encode(_poly_boundary_counts(p, h, w))}
                for p in polys]
        return rles[0] if len(rles) == 1 else merge(rles)
    import cv2
    mask = np.zeros((h, w), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polys]
    cv2.fillPoly(mask, pts, 1)
    return encode(mask)


def fr_uncompressed(rle_obj: Dict) -> RLE:
    """Uncompressed-counts RLE dict -> compressed RLE."""
    h, w = rle_obj["size"]
    return {"size": [h, w],
            "counts": str_encode(np.asarray(rle_obj["counts"], np.uint32))}


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
