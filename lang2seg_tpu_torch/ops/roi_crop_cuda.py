"""The ROI crop: the hand-written CUDA kernels (`csrc/roi_crop.cu`), a
bilinear 4-tap gather forward and its fixed-order backward with respect to
the map.

No Pallas kernel precedes them: the JAX package computes the crop in plain
XLA as two einsums against hat weights (`lang2seg_tpu/ops/roi_align.py::
crop_and_resize`), a form shaped by the TPU's matrix unit.
`ops/roi_align.py::crop_and_resize` calls these wrappers for CUDA tensors
and its plain version (that einsum pair) for CPU tensors. Both read the
sample coordinates `_sample_coords` computes.

The forward takes a thread a (ROI, sample column, 16-byte channel vector)
that computes its column's x taps once and walks the sample rows, every
output written once with a streaming store; it reads four tap vectors an
output, from L2. The backward takes a CTA of one warp a (expression, 4
pixels of a map row, slab of channels), a lane a 16-byte vector of
channels and its 4 sums in registers: the warp walks the ROIs in order,
32 at a time (a lane testing whether ROI q's taps can reach its pixels),
and for each that can it finds the sample columns with a tap among its
pixels and the sample rows with a weight on its row (a ballot), then sums
those terms. A ROI costs a warp its terms on the warp's pixels, so the
backward's cost follows the ROIs' S x S samples, not their area. Each
element is summed in the one order (ROI, sample column) of
`crop_bwd_coords_plain`, no atomics, and rounded once.

`band_plan` is how the wrapper's backward cuts the maps: pixels a warp
(4, or 1 for a launch of few warps), warps a row, channels a slab.
`roi_crop_forward` / `roi_crop_backward` count their launches in
`roi_crop.launches` / `roi_crop.bwd_launches` by `shape_key`
(`utils/trace.py`). `launch_forward` / `launch_backward` launch without
counting, for tools that compare or time the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ..utils.trace import count, span
from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
# the backward's pixels of a row a warp (a CTA of one warp): 4, or 1 where
# that gives fewer warps than WIDE_WARPS (32 warps on each of an H100's
# 132 SMs: small maps, few expressions), so that the card still has warps
# to spread
SEG_COLS = 4
WIDE_WARPS = 132 * 32
MAX_SAMPLES = 16


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("roi_crop")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.roi_crop_fwd_launch.argtypes = [p, ll, i, i, i, i, i, p, p, i, i, p,
                                        p]
    lib.roi_crop_fwd_launch.restype = i
    lib.roi_crop_bwd_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p,
                                        p]
    lib.roi_crop_bwd_launch.restype = i
    return lib


def band_plan(h: int, w: int, c: int, dtype: torch.dtype, s: int = 7,
              e: int = 1) -> Dict[str, int]:
    """How the backward cuts E (h, w, c) maps of `dtype` for S x S crops:
    a CTA of one warp (`threads`) for each `pixels` pixels of a row
    (`SEG_COLS`, or 1 where that gives fewer than `WIDE_WARPS` warps;
    `segments` a row, `ctas` a map and slab) and each slab of `channels`
    channels (a 16-byte vector a lane: 256 bf16 or 128 f32; `slabs` of
    them), its sums in registers; `smem` bytes of shared memory (none)."""
    elem = torch.empty((), dtype=dtype).element_size()
    channels = 32 * 16 // elem
    slabs = -(-c // channels)
    pixels = SEG_COLS if h * -(-w // SEG_COLS) * slabs * e >= WIDE_WARPS \
        else 1
    segments = -(-w // pixels)
    return {"channels": channels, "slabs": slabs, "pixels": pixels,
            "segments": segments, "ctas": h * segments, "threads": 32,
            "smem": 0}


def shape_key(e: int, r: int, s: int, h: int, w: int, c: int,
              dtype: torch.dtype) -> Tuple:
    """The key a launch counts under for a crop of (E, R, 4) ROIs at
    S x S samples from (E, H, W, C) maps of `dtype`."""
    return (e, r, s, h, w, c, str(dtype).split(".")[-1])


def _check_coords(ys: torch.Tensor, xs: torch.Tensor, e: int,
                  device: torch.device) -> Tuple[int, int]:
    if ys.dim() != 3 or ys.shape != xs.shape or ys.shape[0] != e or \
            ys.dtype != torch.float32 or xs.dtype != torch.float32 or \
            not ys.is_contiguous() or not xs.is_contiguous() or \
            ys.device != device or xs.device != device:
        raise ValueError(f"roi_crop: ys and xs must be contiguous (E, R, S) "
                         f"float32 on the map's device, got "
                         f"{tuple(ys.shape)} {ys.dtype} and "
                         f"{tuple(xs.shape)} {xs.dtype}")
    r, s = ys.shape[1], ys.shape[2]
    if not 2 <= s <= MAX_SAMPLES:
        raise ValueError(f"roi_crop: the kernels take 2 to {MAX_SAMPLES} "
                         f"samples a side, got {s}")
    return r, s


def _check_map(feat: torch.Tensor) -> None:
    if feat.device.type != "cuda":
        raise ValueError(f"roi_crop: feat must be a CUDA tensor, got "
                         f"{feat.device}")
    if feat.dtype not in _DTYPES or feat.dim() != 4:
        raise ValueError(f"roi_crop: feat must be (E, H, W, C) float32 or "
                         f"bfloat16, got {tuple(feat.shape)} {feat.dtype}")
    _, h, w, c = feat.shape
    if feat.stride()[1:] != (w * c, c, 1) and h * w * c > 0:
        raise ValueError("roi_crop: each expression's (H, W, C) map must be "
                         "contiguous")
    if c % 8 or (feat.stride(0) * feat.element_size()) % 16 or \
            feat.data_ptr() % 16:
        raise ValueError("roi_crop: C must be a multiple of 8, and the map "
                         "and its expression stride 16-byte aligned")


def launch_forward(feat: torch.Tensor, ys: torch.Tensor,
                   xs: torch.Tensor) -> torch.Tensor:
    """One launch of the forward kernel, counted nowhere: feat (E, H, W, C)
    bf16 or f32 on the card (each expression's map contiguous, the
    expression stride free, 0 for a broadcast map), ys / xs (E, R, S) f32
    sample coordinates in map cells -> (E, R, S, S, C) in feat's dtype."""
    _check_map(feat)
    e, h, w, c = feat.shape
    r, s = _check_coords(ys, xs, e, feat.device)
    out = torch.empty((e, r, s, s, c), dtype=feat.dtype, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    with torch.cuda.device(feat.device):
        rc = _lib().roi_crop_fwd_launch(
            feat.data_ptr(), feat.stride(0), e, h, w, c,
            int(feat.dtype == torch.bfloat16), ys.data_ptr(), xs.data_ptr(),
            r, s, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"roi_crop forward launch failed: cudaError {rc}")
    return out


@span("l2s.roi_crop_fwd")
def roi_crop_forward(feat: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """`launch_forward`, counted in `roi_crop.launches`."""
    out = launch_forward(feat, ys, xs)
    e, h, w, c = feat.shape
    count("roi_crop.launches", key=shape_key(e, ys.shape[1], ys.shape[2], h,
                                             w, c, feat.dtype))
    return out


def launch_backward(grad: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    h: int, w: int) -> torch.Tensor:
    """One launch of the backward kernel, counted nowhere: grad (E, R, S,
    S, C) of the crops, contiguous on the card; ys / xs as the forward
    took them -> the maps' gradient (E, h, w, C) in grad's dtype, each
    element summed in f32 in one fixed order and rounded once."""
    if grad.device.type != "cuda" or grad.dtype not in _DTYPES or \
            grad.dim() != 5 or not grad.is_contiguous() or \
            grad.data_ptr() % 16 or grad.shape[2] != grad.shape[3]:
        raise ValueError(f"roi_crop backward: grad must be a contiguous (E, "
                         f"R, S, S, C) float32 or bfloat16 CUDA tensor, got "
                         f"{tuple(grad.shape)} {grad.dtype} on "
                         f"{grad.device}")
    e, r, s, _, c = grad.shape
    if _check_coords(ys, xs, e, grad.device) != (r, s) or c % 8:
        raise ValueError("roi_crop backward: grad must be shaped as the "
                         "forward's output, C a multiple of 8")
    plan = band_plan(h, w, c, grad.dtype, s, e)
    dfeat = torch.empty((e, h, w, c), dtype=grad.dtype, device=grad.device)
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    with torch.cuda.device(grad.device):
        rc = _lib().roi_crop_bwd_launch(
            grad.data_ptr(), ys.data_ptr(), xs.data_ptr(), e, h, w, c,
            int(grad.dtype == torch.bfloat16), r, s, plan["pixels"],
            dfeat.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"roi_crop backward launch failed: cudaError {rc}")
    return dfeat


@span("l2s.roi_crop_bwd")
def roi_crop_backward(grad: torch.Tensor, ys: torch.Tensor,
                      xs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`launch_backward`, counted in `roi_crop.bwd_launches`."""
    dfeat = launch_backward(grad, ys, xs, h, w)
    e, r, s, _, c = grad.shape
    count("roi_crop.bwd_launches",
          key=shape_key(e, r, s, h, w, c, grad.dtype))
    return dfeat
