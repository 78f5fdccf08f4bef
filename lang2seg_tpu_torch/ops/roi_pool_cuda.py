"""ROI max pooling: the hand-written CUDA kernels (`csrc/roi_pool.cu`),
forward with argmax and the argmax backward.

No Pallas kernel precedes them: the JAX package computes the op in plain
XLA (`lang2seg_tpu/ops/roi_align.py::roi_max_pool`), whose masked maxima
eager PyTorch cannot run at full width, and the reference shipped it as
CUDA (`roi_pooling_kernel.cu`). `ops/roi_align.py::roi_max_pool` calls
these wrappers for CUDA tensors and its plain version for CPU tensors.
`launches` and `bwd_launches` count the two C entries' launches;
`shapes` and `bwd_shapes` count the same launches by `shape_key`.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

launches = 0
bwd_launches = 0
shapes: collections.Counter = collections.Counter()
bwd_shapes: collections.Counter = collections.Counter()

_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("roi_pool")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.roi_pool_fwd_launch.argtypes = [p, ctypes.c_longlong, i, i, i, i, i,
                                        p, i, i, ctypes.c_float, p, p, p]
    lib.roi_pool_fwd_launch.restype = i
    lib.roi_pool_bwd_launch.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p]
    lib.roi_pool_bwd_launch.restype = i
    return lib


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
              dtype: torch.dtype, with_argmax: bool) -> Tuple:
    """The key of `shapes` / `bwd_shapes` for a launch on (E, H, W, C)
    maps of `dtype` with (E, R, 4) ROIs."""
    return (e, r, pooled, h, w, c, str(dtype).split(".")[-1],
            bool(with_argmax))


def roi_pool_forward(feat: torch.Tensor, rois: torch.Tensor, pooled: int,
                     spatial_scale: float, with_argmax: bool = True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """feat (E, H, W, C) bf16 or f32 on the card (the expression stride
    free, 0 for a broadcast map); rois (E, R, 4) in image coords ->
    (out (E, R, P, P, C) in feat's dtype, argmax (E, R, P, P, C) int32:
    y * W + x of each bin's first maximum, -1 for an empty bin; None,
    and nothing written for it, when not `with_argmax`)."""
    _check_map(feat)
    e, h, w, c = feat.shape
    if rois.dim() != 3 or rois.shape[0] != e or rois.shape[2] != 4 \
            or rois.device != feat.device:
        raise ValueError(f"roi_pool: rois must be (E, R, 4) on feat's device, "
                         f"got {tuple(rois.shape)} on {rois.device}")
    rois = rois.float().contiguous()
    r = rois.shape[1]
    out = torch.empty((e, r, pooled, pooled, c), dtype=feat.dtype,
                      device=feat.device)
    argmax = torch.empty(out.shape, dtype=torch.int32,
                         device=feat.device) if with_argmax else None
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    with torch.cuda.device(feat.device):
        rc = _lib().roi_pool_fwd_launch(
            feat.data_ptr(), feat.stride(0), e, h, w, c,
            int(feat.dtype == torch.bfloat16), rois.data_ptr(), r, pooled,
            float(spatial_scale), out.data_ptr(),
            argmax.data_ptr() if with_argmax else None, stream)
    if rc != 0:
        raise RuntimeError(f"roi_pool forward launch failed: cudaError {rc}")
    global launches
    launches += 1
    shapes[shape_key(e, r, pooled, h, w, c, feat.dtype, with_argmax)] += 1
    return out, argmax


def roi_pool_backward(grad: torch.Tensor, argmax: torch.Tensor,
                      feat_shape: Tuple[int, ...], dtype: torch.dtype
                      ) -> torch.Tensor:
    """grad (E, R, P, P, C) of the forward's output, argmax as the forward
    returned it -> the map's gradient (E, H, W, C) in `dtype`: each
    output's gradient added in f32 at its argmax (atomics, in no fixed
    order), then cast once."""
    e, h, w, c = feat_shape
    if grad.device.type != "cuda" or grad.dtype != dtype or \
            not grad.is_contiguous() or grad.shape != argmax.shape or \
            argmax.dtype != torch.int32 or not argmax.is_contiguous() or \
            grad.shape[0] != e or grad.shape[-1] != c:
        raise ValueError("roi_pool backward: grad must be a contiguous CUDA "
                         "tensor of the map's dtype shaped as argmax")
    dfeat = torch.empty(feat_shape, dtype=dtype, device=grad.device)
    acc = dfeat if dtype == torch.float32 else torch.empty(
        feat_shape, dtype=torch.float32, device=grad.device)
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    with torch.cuda.device(grad.device):
        rc = _lib().roi_pool_bwd_launch(
            grad.data_ptr(), argmax.data_ptr(), e, h, w, c,
            int(dtype == torch.bfloat16), grad.shape[1], grad.shape[2],
            acc.data_ptr(), dfeat.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"roi_pool backward launch failed: cudaError {rc}")
    global bwd_launches
    bwd_launches += 1
    bwd_shapes[shape_key(e, grad.shape[1], grad.shape[2], h, w, c, dtype,
                         True)] += 1
    return dfeat
