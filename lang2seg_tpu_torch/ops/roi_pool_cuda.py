"""ROI max pooling: the hand-written CUDA kernels (`csrc/roi_pool.cu`),
forward with argmax and the argmax backward.

No Pallas kernel precedes them: the JAX package computes the op in plain
XLA (`lang2seg_tpu/ops/roi_align.py::roi_max_pool`), whose masked maxima
eager PyTorch cannot run at full width, and the reference shipped it as
CUDA (`roi_pooling_kernel.cu`). `ops/roi_align.py::roi_max_pool` calls
these wrappers for CUDA tensors and its plain version for CPU tensors.

`slab_plan` is how the wrapper cuts a map for the kernels: the channels a
CTA holds (a 32-byte slab of each pixel), the forward's route (the whole
slab in shared memory, or the global scan for a map beyond it), the
backward's bands of rows, and the argmax's code type. The argmax is the
kernels' own: a bin-local offset of one or two bytes, slab-major
(`encode_argmax` is its plain version, `decode_argmax` turns it back into
y * W + x). `roi_pool_forward` / `roi_pool_backward` count their
launches in `roi_pool.launches` / `roi_pool.bwd_launches` by `shape_key`
(`utils/trace.py`), whose last field is the kernel the launch ran.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ..utils.trace import count
from . import _build
from .roi_align import roi_max_pool_argmax_plain, roi_pool_bins

_DTYPES = (torch.float32, torch.bfloat16)
# dynamic shared memory a block of the kernels takes at most: the 227 KiB
# (232,448 B) one block may opt in to on an H100, less 64 B of static
SMEM_BYTES = 227 * 1024 - 64
# a pixel of the forward's slab: one 32-byte sector of the map
SLAB_BYTES = 32
# the corners and bin sizes of 512 ROIs, 16 B each, beside either slab
GEOM_BYTES = 512 * 16
# the backward's static shared memory (its rescan's item list and scratch,
# a table of reciprocals)
BWD_STATIC_BYTES = 8 * 1024
# the few-ROI forward: items (ROI, bin, 16-byte chunk) it takes at most,
# a thread each, and its band of rows in shared memory (48 KiB timed no
# slower than 16 KiB at any crop shape, faster at most:
# `profile_roi_pool.route_ms`)
FEW_ROI_ITEMS = 512
BAND_BYTES = 48 * 1024


# the library the wrappers launch: "roi_pool", or its measuring variant
# "roi_pool_clocks" (tools/profile_roi_pool.py::phase_clocks)
library = "roi_pool"


def _lib():
    return _bound(library)


@functools.lru_cache(maxsize=None)
def _bound(name: str):
    lib = _build.load(name)
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.roi_pool_fwd_launch.argtypes = [p, ll, i, i, i, i, i, p, i, i, f, i,
                                        i, p, p, i, p]
    lib.roi_pool_fwd_launch.restype = i
    lib.roi_pool_bwd_launch.argtypes = [p, p, i, p, ll, i, i, i, i, i, p, i,
                                        i, f, i, p, p]
    lib.roi_pool_bwd_launch.restype = i
    return lib


def max_bin(h: int, w: int, pooled: int) -> Tuple[int, int]:
    """(rows, columns) of the largest bin of a ROI whose rounded corners
    lie on the (h, w) map: an extent of at most w + 1 cells gives bins of
    at most ceil((w + 1) / P) + 1 columns."""
    return (min(h, -(-(h + 1) // pooled) + 1),
            min(w, -(-(w + 1) // pooled) + 1))


def slab_plan(h: int, w: int, c: int, dtype: torch.dtype,
              pooled: int = 7) -> Dict[str, object]:
    """How the kernels cut an (E, h, w, c) map of `dtype`: `channels` a
    CTA (32 bytes of a pixel: 16 bf16 or 8 f32) in `slabs` slabs; the
    argmax's code type, uint8 while the largest in-map bin (`max_bin`)
    fits under the code 255 (which marks a bin to rescan), else uint16;
    the forward's route, "smem" (the map through shared memory: the slab,
    h * w * 32 bytes, up to 7006 pixels, or for a few ROIs bands of rows,
    `forward_kernel`) or "scan" (each window scanned in global memory);
    the backward's f32 slab by bands of `band_rows` rows, route "smem"
    for one band (up to 3375 pixels of a bf16 map, 6750 of an f32 one;
    `BWD_STATIC_BYTES` kept for its static shared memory) or "bands".
    Each slab sits beside `GEOM_BYTES` of ROIs."""
    elem = torch.empty((), dtype=dtype).element_size()
    cs = SLAB_BYTES // elem
    rows, cols = max_bin(h, w, pooled)
    fwd_smem = h * w * SLAB_BYTES + GEOM_BYTES
    row_bytes = w * cs * 4
    band_rows = min(h, (SMEM_BYTES - GEOM_BYTES - BWD_STATIC_BYTES)
                    // row_bytes)
    if band_rows == 0:
        raise ValueError(f"roi_pool: a map row of {w} pixels does not fit "
                         f"the backward's shared memory ({SMEM_BYTES} B)")
    bands = -(-h // band_rows)
    return {"channels": cs, "slabs": -(-c // cs),
            "code_dtype": torch.uint8 if rows * cols <= 255
            else torch.uint16,
            "forward": {"route": "smem" if fwd_smem <= SMEM_BYTES
                        else "scan",
                        "smem": fwd_smem if fwd_smem <= SMEM_BYTES else 0},
            "backward": {"route": "smem" if bands == 1 else "bands",
                         "band_rows": band_rows, "bands": bands,
                         "smem": band_rows * row_bytes + GEOM_BYTES}}


def roi_groups(e: int, r: int, slabs: int, sms: int) -> int:
    """The groups an expression's R ROIs are split into for the slab
    kernel (a CTA for each expression, slab and group): one while the E x
    slabs CTAs fill the card's `sms` SMs, else enough for two CTAs an SM,
    with at least 16 ROIs a group. Measured on an H100 (132 SMs): the demo's
    1 x 300 ROIs (32 CTAs, 9 groups) 0.0513 -> 0.0258 ms; 16 x 256 (512
    CTAs) takes one group."""
    ctas = e * slabs
    if ctas >= sms:
        return 1
    return max(1, min(-(-2 * sms // ctas), -(-r // 16)))


def forward_kernel(plan: Dict[str, object], e: int, r: int, w: int,
                   pooled: int, sms: int) -> Tuple[str, int, int]:
    """(kernel, route id, its argument) of a forward launch on the
    plan's map: the global scan ("scan") past the single-CTA slab; else
    the few-ROI kernel ("few_rois": a thread an item, the ROIs' rectangle
    through shared memory in bands of whole rows, `BAND_BYTES` at least)
    for at most `FEW_ROI_ITEMS` items an expression when the slab
    kernel's E x slabs CTAs, two an SM, would take more than one wave of
    the card's `sms` SMs, or less than half of one; else the slab kernel
    ("slab") with `roi_groups` groups. The mask crops on an H100 (132
    SMs; `profile_roi_pool.crop_routes`): at 512 and 1024 CTAs (16 x 1,
    16 x 2) the few-ROI kernel 12-28% faster than the slab kernel, at 256
    (8 x 1, 8 x 2) 5-12% slower, at 128 (4 x 1, 4 x 2) within 2%, at 32
    (the demo's 1 x 1) 14% faster."""
    if plan["forward"]["route"] == "scan":
        return "scan", 1, 1
    ctas = e * plan["slabs"]
    if 2 * pooled * pooled * r <= FEW_ROI_ITEMS and \
            (ctas > 2 * sms or 2 * ctas < sms):
        return "few_rois", 2, max(BAND_BYTES // SLAB_BYTES, w)
    return "slab", 0, roi_groups(e, r, plan["slabs"], sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sentinel(code_dtype: torch.dtype) -> int:
    return 255 if code_dtype == torch.uint8 else 65535


def _check_map(feat: torch.Tensor) -> None:
    if feat.device.type != "cuda":
        raise ValueError(f"roi_pool: feat must be a CUDA tensor, got "
                         f"{feat.device}")
    if feat.dtype not in _DTYPES or feat.dim() != 4:
        raise ValueError(f"roi_pool: feat must be (E, H, W, C) float32 or "
                         f"bfloat16, got {tuple(feat.shape)} {feat.dtype}")
    _, h, w, c = feat.shape
    if feat.stride()[1:] != (w * c, c, 1) and h * w * c > 0:
        raise ValueError("roi_pool: each expression's (H, W, C) map must be "
                         "contiguous")
    if c % 2 or feat.stride(0) % 2 or \
            feat.data_ptr() % (2 * feat.element_size()):
        raise ValueError("roi_pool: C and the expression stride must be even "
                         "and the map aligned to a channel pair")


def shape_key(e: int, r: int, pooled: int, h: int, w: int, c: int,
              dtype: torch.dtype, with_argmax: bool, kernel: str) -> Tuple:
    """The key a launch on (E, H, W, C) maps of `dtype` with (E, R, 4)
    ROIs counts under; its last field is the kernel the launch ran (the
    forward's `forward_kernel` name, the backward's `slab_plan` route)."""
    return (e, r, pooled, h, w, c, str(dtype).split(".")[-1],
            bool(with_argmax), kernel)


def roi_pool_forward(feat: torch.Tensor, rois: torch.Tensor, pooled: int,
                     spatial_scale: float, with_argmax: bool = True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """feat (E, H, W, C) bf16 or f32 on the card (the expression stride
    free, 0 for a broadcast map); rois (E, R, 4) in image coords ->
    (out (E, R, P, P, C) in feat's dtype, codes: each output's argmax as
    the kernels keep it, (E, slabs, R, P, P, channels) of the plan's code
    type (`decode_argmax`); None, and nothing written for it, when not
    `with_argmax`)."""
    _check_map(feat)
    e, h, w, c = feat.shape
    if rois.dim() != 3 or rois.shape[0] != e or rois.shape[2] != 4 \
            or rois.device != feat.device:
        raise ValueError(f"roi_pool: rois must be (E, R, 4) on feat's device, "
                         f"got {tuple(rois.shape)} on {rois.device}")
    r = rois.shape[1]
    plan = slab_plan(h, w, c, feat.dtype, pooled)
    index = feat.device.index
    kernel, route, arg = forward_kernel(plan, e, r, w, pooled, _sm_count(
        torch.cuda.current_device() if index is None else index))
    out, codes = launch_forward(feat, rois, pooled, spatial_scale, route,
                                arg, with_argmax)
    count("roi_pool.launches", key=shape_key(e, r, pooled, h, w, c,
                                             feat.dtype, with_argmax, kernel))
    return out, codes


def launch_forward(feat: torch.Tensor, rois: torch.Tensor, pooled: int,
                   spatial_scale: float, route: int, arg: int,
                   with_argmax: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward on a given route (`forward_kernel`'s id
    and argument), counted nowhere: `roi_pool_forward` less the choice,
    for tools that time the routes against each other."""
    e, h, w, c = feat.shape
    rois = rois.float().contiguous()
    r = rois.shape[1]
    plan = slab_plan(h, w, c, feat.dtype, pooled)
    out = torch.empty((e, r, pooled, pooled, c), dtype=feat.dtype,
                      device=feat.device)
    codes = torch.empty((e, plan["slabs"], r, pooled, pooled,
                         plan["channels"]), dtype=plan["code_dtype"],
                        device=feat.device) if with_argmax else None
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    with torch.cuda.device(feat.device):
        rc = _lib().roi_pool_fwd_launch(
            feat.data_ptr(), feat.stride(0), e, h, w, c,
            int(feat.dtype == torch.bfloat16), rois.data_ptr(), r, pooled,
            float(spatial_scale), route, arg, out.data_ptr(),
            codes.data_ptr() if with_argmax else None,
            codes.element_size() if with_argmax else 0, stream)
    if rc != 0:
        raise RuntimeError(f"roi_pool forward launch failed: cudaError {rc}")
    return out, codes


def roi_pool_backward(grad: torch.Tensor, codes: torch.Tensor,
                      feat: torch.Tensor, rois: torch.Tensor, pooled: int,
                      spatial_scale: float) -> torch.Tensor:
    """grad (E, R, P, P, C) of the forward's output, codes as the forward
    returned them, feat and rois as it took them (the map is read only to
    rescan a bin too large for its code) -> the map's gradient (E, H, W,
    C) in feat's dtype: each output's gradient added in f32 at its argmax
    (shared-memory atomics, in no fixed order), each element rounded once
    and written once."""
    e, h, w, c = feat.shape
    plan = slab_plan(h, w, c, feat.dtype, pooled)
    r = grad.shape[1] if grad.dim() == 5 else -1
    if grad.device.type != "cuda" or grad.dtype != feat.dtype or \
            not grad.is_contiguous() or \
            tuple(grad.shape) != (e, r, pooled, pooled, c) or \
            codes.dtype != plan["code_dtype"] or not codes.is_contiguous() or \
            tuple(codes.shape) != (e, plan["slabs"], r, pooled, pooled,
                                   plan["channels"]):
        raise ValueError("roi_pool backward: grad must be a contiguous CUDA "
                         "tensor of the map's dtype shaped as the output, "
                         "codes as the forward returned them")
    _check_map(feat)
    rois = rois.float().contiguous()
    dfeat = torch.empty((e, h, w, c), dtype=feat.dtype, device=grad.device)
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    with torch.cuda.device(grad.device):
        rc = _lib().roi_pool_bwd_launch(
            grad.data_ptr(), codes.data_ptr(), codes.element_size(),
            feat.data_ptr(), feat.stride(0), e, h, w, c,
            int(feat.dtype == torch.bfloat16), rois.data_ptr(), r, pooled,
            float(spatial_scale), plan["backward"]["band_rows"],
            dfeat.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"roi_pool backward launch failed: cudaError {rc}")
    count("roi_pool.bwd_launches", key=shape_key(
        e, r, pooled, h, w, c, feat.dtype, True, plan["backward"]["route"]))
    return dfeat


def _bins(rois, pooled, spatial_scale, h, w):
    """Each bin's edges broadcast to (E, R, P, P, 1): hs, he, ws, we."""
    hs, he, ws, we = roi_pool_bins(rois, pooled, spatial_scale, h, w)
    return (hs[..., :, None, None], he[..., :, None, None],
            ws[..., None, :, None], we[..., None, :, None])


def encode_argmax(argmax: torch.Tensor, rois: torch.Tensor, pooled: int,
                  spatial_scale: float, h: int, w: int,
                  plan: Dict[str, object]) -> torch.Tensor:
    """The plain version of the codes the forward kernel writes: argmax
    (E, R, P, P, C) of y * W + x (`roi_max_pool_argmax_plain`) -> each
    bin-local offset (y - hs) * (we - ws) + (x - ws), the largest code for
    a bin of more pixels than the code can count, 0 for an empty bin,
    laid out (E, slabs, R, P, P, channels) with the last slab's channels
    beyond C zero."""
    e, r, _, _, c = argmax.shape
    hs, he, ws, we = _bins(rois, pooled, spatial_scale, h, w)
    y, x = argmax // w, argmax % w
    off = (y - hs) * (we - ws) + (x - ws)
    area = (he - hs).clamp(min=0) * (we - ws).clamp(min=0)
    top = _sentinel(plan["code_dtype"])
    off = torch.where(area > top, top, off)
    off = torch.where(area == 0, 0, off)
    cs, slabs = plan["channels"], plan["slabs"]
    full = off.new_zeros((e, r, pooled, pooled, slabs * cs))
    full[..., :c] = off
    full = full.reshape(e, r, pooled, pooled, slabs, cs)
    return full.permute(0, 4, 1, 2, 3, 5).contiguous().to(plan["code_dtype"])


def decode_argmax(codes: torch.Tensor, rois: torch.Tensor, pooled: int,
                  spatial_scale: float, feat: torch.Tensor) -> torch.Tensor:
    """The kernels' codes back to the argmax of `roi_max_pool_argmax_plain`:
    (E, R, P, P, C) int64 of y * W + x, -1 for an empty bin. A bin that
    holds the largest code is rescanned in `feat` (the plain argmax of its
    ROI alone). Plain torch, on either device."""
    e, h, w, c = feat.shape
    s, cs = codes.shape[1], codes.shape[-1]
    r = codes.shape[2]
    off = codes.permute(0, 2, 3, 4, 1, 5).reshape(
        e, r, pooled, pooled, s * cs)[..., :c].long()
    hs, he, ws, we = _bins(rois, pooled, spatial_scale, h, w)
    bw = (we - ws).clamp(min=1)
    pos = (hs + off // bw) * w + ws + off % bw
    top = _sentinel(codes.dtype)
    redo = (off == top) & ((he - hs) * (we - ws) > top)
    for i, j in torch.nonzero(redo.flatten(2).any(2)).tolist():
        pos[i, j] = torch.where(redo[i, j], roi_max_pool_argmax_plain(
            feat[i:i + 1], rois[i:i + 1, j:j + 1], pooled,
            spatial_scale)[0, 0], pos[i, j])
    return torch.where((he <= hs) | (we <= ws), -1, pos)
