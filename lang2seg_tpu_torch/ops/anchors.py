"""Anchor generation (numpy; counterpart of `lang2seg_tpu/ops/anchors.py`).

Base-anchor enumeration reproduces the reference's MATLAB-derived rounding
semantics (`layer_utils/generate_anchors.py:41-111`). Anchor ordering is
(H, W, A) with A fastest — matching the reference's `generate_anchors_pre`
(layer_utils/snippets.py:13-29) so RPN outputs laid out (H, W, A, ...)
align index for index.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def generate_base_anchors(base_size: int = 16,
                          ratios=(0.5, 1, 2),
                          scales=(8, 16, 32)) -> np.ndarray:
    """(A, 4) float32 base anchors centered on the (0,0,15,15) window."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)

    w = h = float(base_size)
    x_ctr = y_ctr = (base_size - 1) * 0.5
    size = w * h

    anchors = []
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            sw, sh = ws * s, hs * s
            anchors.append([x_ctr - 0.5 * (sw - 1), y_ctr - 0.5 * (sh - 1),
                            x_ctr + 0.5 * (sw - 1), y_ctr + 0.5 * (sh - 1)])
    return np.asarray(anchors, dtype=np.float32)


@functools.lru_cache(maxsize=16)
def _shifted_anchors_np(height: int, width: int, feat_stride: int,
                        scales, ratios) -> np.ndarray:
    base = generate_base_anchors(16, ratios, scales)             # (A, 4)
    sx = np.arange(width, dtype=np.float32) * feat_stride
    sy = np.arange(height, dtype=np.float32) * feat_stride
    shift = np.stack(
        [np.tile(sx[None, :], (height, 1)),
         np.tile(sy[:, None], (1, width)),
         np.tile(sx[None, :], (height, 1)),
         np.tile(sy[:, None], (1, width))], axis=-1)             # (H, W, 4)
    all_anchors = shift[:, :, None, :] + base[None, None, :, :]  # (H, W, A, 4)
    return np.ascontiguousarray(all_anchors.reshape(-1, 4))


@functools.lru_cache(maxsize=16)
def _shifted_anchors_on(height: int, width: int, feat_stride: int, scales,
                        ratios, device: str) -> torch.Tensor:
    return torch.from_numpy(_shifted_anchors_np(
        height, width, feat_stride, scales, ratios)).to(device)


def shifted_anchors(height: int, width: int, feat_stride: int,
                    scales=(8, 16, 32), ratios=(0.5, 1, 2),
                    device="cpu") -> torch.Tensor:
    """All anchors over an H x W feature grid: (H*W*A, 4) float32,
    ordered (H, W, A), on `device`. The tensor is copied to a device once
    and shared by later calls (callers must not write to it), so a
    training step makes no host-to-device copy for it."""
    return _shifted_anchors_on(height, width, feat_stride, tuple(scales),
                               tuple(ratios), str(torch.device(device)))
