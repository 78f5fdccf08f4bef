"""The least time greedy NMS could take on a call's own inputs and output
(a copy of the measured package's `tools/profile_nms.py::nms_bound`):
the boxes and valid bits read once and the kept indices and mask written
once, against HBM bandwidth; the IoU tests this data needs, each box up
to the last one the pass examines against every kept box before it, at
15 f32 operations a test, against the f32 peak. The larger bounds."""

from __future__ import annotations

import numpy as np

from .peaks import F32_FLOPS, HBM_BYTES_PER_S

# 4 min/max, 4 sub/add for the overlap, 2 clamps, 1 mul, 1 add + 1 sub
# for the union, 1 div, 1 compare; areas are a box's, not a pair's
OPS_PER_PAIR = 15


def pairs(keep_idx: np.ndarray, keep_mask: np.ndarray, n: int,
          max_out: int) -> int:
    """IoU tests the greedy pass needs on this data."""
    total = 0
    for lane in range(keep_idx.shape[0]):
        kept = keep_idx[lane][keep_mask[lane]].astype(np.int64)
        if len(kept) == 0:
            continue
        last = kept[-1] if len(kept) == max_out else n - 1
        total += int(np.sum(last - kept))
    return total


def bound_s(e: int, n: int, max_out: int, keep_idx: np.ndarray,
            keep_mask: np.ndarray) -> float:
    byts = e * n * 16 + e * n + e * max_out * 5
    ops = pairs(keep_idx, keep_mask, n, max_out) * OPS_PER_PAIR
    return max(byts / HBM_BYTES_PER_S, ops / F32_FLOPS)
