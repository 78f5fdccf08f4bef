"""Debug visualization dumps and the demo's drawing, without Pillow or cv2.

Counterpart of `lang2seg_tpu/utils/visualization.py`: response maps and
backbone channels saved as 8-bit grey PNGs under `response/` and
`net_conv/` (the reference's save=1 side channel, nets/network.py:481-
517), and boxes drawn on a BGR image. The card's machine has neither
Pillow nor cv2, so `write_png` is the port's own PNG encoder (zlib and
struct) and `draw_boxes` paints cv2's `rectangle(..., thickness=2)` in
NumPy, pixel for pixel. It paints no label text: the JAX package writes
the class with `cv2.putText`, whose anti-aliased glyphs the port does not
copy (ROADMAP Queue 3); the demo prints the class instead.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(array: np.ndarray) -> bytes:
    """PNG bytes of a uint8 (H, W) grey image (colour type 0) or (H, W, 3)
    BGR image, stored as RGB (colour type 2) as cv2.imwrite stores it; 8
    bits a sample, no interlace, filter 0 (none) on every row, the rows
    deflated with zlib."""
    a = np.asarray(array)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3
                                                   and a.shape[2] == 3)):
        raise ValueError(f"write_png: a uint8 (H, W) or (H, W, 3) image, got "
                         f"{a.shape} {a.dtype}")
    h, w = a.shape[:2]
    if a.ndim == 3:
        a = a[:, :, ::-1]                        # BGR -> RGB
    color_type = 0 if a.ndim == 2 else 2
    rows = np.ascontiguousarray(a).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The image of a PNG as `encode_png` writes it (8-bit grey or RGB,
    one IDAT, every row filter 0), checking the signature, the IHDR and
    each chunk's CRC; an RGB image comes back as BGR. Raises ValueError on
    anything else."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("decode_png: not a PNG signature")
    chunks, pos = {}, 8
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"decode_png: bad CRC in {kind!r}")
        chunks.setdefault(kind, []).append(body)
        pos += 12 + n
    w, h, depth, color_type, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", chunks[b"IHDR"][0])
    if (depth, comp, filt, interlace) != (8, 0, 0, 0) or \
            color_type not in (0, 2) or len(chunks[b"IDAT"]) != 1 or \
            b"IEND" not in chunks:
        raise ValueError("decode_png: not a PNG that encode_png writes")
    ch = 1 if color_type == 0 else 3
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"][0]), np.uint8)
    rows = raw.reshape(h, 1 + w * ch)
    if rows[:, 0].any():
        raise ValueError("decode_png: a row with a filter other than 0")
    img = rows[:, 1:].reshape(h, w, ch)
    return img[:, :, 0].copy() if ch == 1 else img[:, :, ::-1].copy()


def write_png(path: str, array: np.ndarray) -> str:
    """Write `array` (see `encode_png`) to `path`; returns the path."""
    data = encode_png(array)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _normalize_to_u8(x: np.ndarray) -> np.ndarray:
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-12:
        return np.zeros_like(x, dtype=np.uint8)
    return ((x - lo) / (hi - lo) * 255.0).astype(np.uint8)


def save_response_map(response: np.ndarray, out_dir: str,
                      file_stem: str, sent_id: int = 0) -> str:
    """Save a (H, W) or (1, H, W, 1) response map, min-max scaled to 0-255,
    as <out_dir>/<stem>_<sent>.png (reference network.py:481-490)."""
    r = np.squeeze(np.asarray(response))
    if r.ndim != 2:
        raise ValueError(f"save_response_map: a 2-d map, got {r.shape}")
    os.makedirs(out_dir, exist_ok=True)
    return write_png(os.path.join(out_dir, f"{file_stem}_{sent_id}.png"),
                     _normalize_to_u8(r))


def save_topk_channels(net_conv: np.ndarray, out_dir: str,
                       file_stem: str, sent_id: int = 0,
                       k: int = 5) -> List[str]:
    """Save the k highest-energy (sum of |x|) channels of a (H, W, C)
    feature map as <out_dir>/<stem>_<sent>_<channel>.png (reference
    network.py:492-517)."""
    f = np.asarray(net_conv)
    energy = np.abs(f).sum(axis=(0, 1))
    top = np.argsort(-energy)[:k]
    os.makedirs(out_dir, exist_ok=True)
    return [write_png(os.path.join(out_dir,
                                   f"{file_stem}_{sent_id}_{int(ch)}.png"),
                      _normalize_to_u8(f[:, :, ch])) for ch in top]


def rectangle_mask(h: int, w: int, p1, p2) -> np.ndarray:
    """The (h, w) pixels that cv2.rectangle(img, p1, p2, color, 2) paints:
    a 3-pixel band centred on each edge of the box spanned by the two
    integer corners (in either order), the four outer corner pixels left
    out (cv2's round caps of radius 1), clipped to the image."""
    xa, xb = sorted((int(p1[0]), int(p2[0])))
    ya, yb = sorted((int(p1[1]), int(p2[1])))
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    rows = ((np.abs(ys - ya) <= 1) | (np.abs(ys - yb) <= 1)) \
        & (xs >= xa) & (xs <= xb)
    cols = ((np.abs(xs - xa) <= 1) | (np.abs(xs - xb) <= 1)) \
        & (ys >= ya) & (ys <= yb)
    return rows | cols


def draw_boxes(image_bgr: np.ndarray, boxes: np.ndarray,
               labels: Optional[Sequence[int]] = None,
               color=(0, 255, 0)) -> np.ndarray:
    """Draw [x1 y1 x2 y2] boxes (corners truncated to int, as the JAX
    package passes them to cv2) 2 pixels thick on a copy of a BGR uint8
    image. `labels` is taken for the JAX signature and not painted."""
    del labels
    out = np.ascontiguousarray(image_bgr).copy()
    h, w = out.shape[:2]
    for b in np.asarray(boxes):
        out[rectangle_mask(h, w, (int(b[0]), int(b[1])),
                           (int(b[2]), int(b[3])))] = color
    return out
