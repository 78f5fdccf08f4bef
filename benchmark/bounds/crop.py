"""The least time the bilinear ROI crop could take on a call's own
arguments (the measured package's `tools/profile_crop.py::crop_bound`
and `crop_bwd_bound`, taking the call's sample coordinates instead of
its ROIs).

Forward (E, H, W, C) map, (E, R, S) y and x sample coordinates: the map
pixels under some tap with a weight that is not zero read once (one map
for a stride-0 map, else each expression's), the coordinates read, the
(E, R, S, S, C) crops written; 12 f32 operations an output (two rows of
two x taps, then two y taps). Backward: the crops' gradient and the
coordinates read, the maps' gradient written in full; the same
operations. The larger of bytes over HBM bandwidth and operations over
the f32 peak."""

from __future__ import annotations

import torch

from .peaks import F32_FLOPS, HBM_BYTES_PER_S

OPS_PER_OUTPUT = 12


def _touched(cs: torch.Tensor, n: int) -> torch.Tensor:
    """(E, R, n): the cells of an axis of n under some tap of (E, R, S)
    coordinates with a weight that is not zero."""
    hit = torch.zeros(cs.shape[:2] + (n + 1,), dtype=torch.bool,
                      device=cs.device)
    first = torch.floor(cs)
    for k in (0, 1):
        idx = first + k
        weight = torch.clamp(1.0 - torch.abs(cs - idx), min=0.0)
        ok = (weight > 0) & (idx >= 0) & (idx < n)
        hit.scatter_(2, torch.where(ok, idx.clamp(0, n - 1).long(), n), True)
    return hit[..., :n]


def tap_pixels(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int,
               broadcast: bool) -> int:
    """Map pixels under some sample's taps: a ROI's tapped rows by its
    tapped columns, over one map for a stride-0 map, else summed over the
    E maps."""
    rows, cols = _touched(ys.float(), h), _touched(xs.float(), w)
    covered = (rows[..., :, None] & cols[..., None, :]).any(1)
    if broadcast:
        covered = covered.any(0)
    return int(covered.sum())


def forward_bound_s(feat_shape, elem: int, broadcast: bool,
                    ys: torch.Tensor, xs: torch.Tensor) -> float:
    e, h, w, c = feat_shape
    r, s = ys.shape[1], ys.shape[2]
    out = e * r * s * s * c
    byts = tap_pixels(ys, xs, h, w, broadcast) * c * elem + \
        2 * ys.numel() * 4 + out * elem
    return max(byts / HBM_BYTES_PER_S, out * OPS_PER_OUTPUT / F32_FLOPS)


def backward_bound_s(grad_shape, elem: int, h: int, w: int) -> float:
    e, r, s, _, c = grad_shape
    out = e * r * s * s * c
    byts = out * elem + 2 * e * r * s * 4 + e * h * w * c * elem
    return max(byts / HBM_BYTES_PER_S, out * OPS_PER_OUTPUT / F32_FLOPS)
