"""Fused language-conditioned gate: the hand-written CUDA kernel
(`csrc/fused_filter.cu`) for CUDA tensors, its plain PyTorch version for
CPU tensors.

Replaces the TPU kernel `lang2seg_tpu/ops/pallas_kernels.py::
fused_dynamic_filter` (forward). Both versions follow that kernel's
arithmetic, not the plain JAX path of `models/dynamic_filter.py`: the
response is scaled by the f32 constant 1/sqrt(C) (not divided by
sqrt(C)), and the gated map is the f32 product conv * g rounded once to
the map's dtype (not a product of g cast to the map's dtype). `launches`
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

launches = 0


def fused_dynamic_filter_plain(net_conv: torch.Tensor, filt: torch.Tensor,
                               rfilt: torch.Tensor, num_filters: int = 7,
                               gate: str = "sigmoid", normalize: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """net_conv (E, H, W, C); filt (E, C, K) f32; rfilt (E, K) f32.
    Returns (gated (E, H, W, C) in net_conv's dtype, response (E, H, W, 1)
    f32)."""
    from ..models.dynamic_filter import spatial_masks_7
    e, h, w, c = net_conv.shape
    k = num_filters
    x = net_conv.float()
    resp = torch.matmul(x.reshape(e, h * w, c), filt.float())
    resp = resp.reshape(e, h, w, k)
    if normalize:
        resp = resp * (1.0 / (c ** 0.5))
    if k == 7:
        masks = spatial_masks_7(h, w, device=net_conv.device)
        resp = resp * masks.permute(1, 2, 0)[None]
        fused = torch.sum(resp * rfilt.float()[:, None, None, :], dim=-1,
                          keepdim=True)
    else:
        fused = resp
    g = torch.sigmoid(fused) if gate == "sigmoid" else fused
    return (x * g).to(net_conv.dtype), fused


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fused_filter")
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.fused_filter_launch.argtypes = [p, ctypes.c_longlong, p, p, i, i, i,
                                        i, i, i, i, ctypes.c_float, p, p, p]
    lib.fused_filter_launch.restype = ctypes.c_int
    return lib


def fused_dynamic_filter(net_conv: torch.Tensor, filt: torch.Tensor,
                         rfilt: torch.Tensor, num_filters: int = 7,
                         gate: str = "sigmoid", normalize: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """See `fused_dynamic_filter_plain`. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream, or
    raises. On the card net_conv is bf16 or f32, and each expression's
    (H, W, C) map must be contiguous; the expression stride may be 0 (a
    broadcast map is read in place, never copied)."""
    if net_conv.device.type == "cpu":
        return fused_dynamic_filter_plain(net_conv, filt, rfilt, num_filters,
                                          gate, normalize)
    if net_conv.device.type != "cuda":
        raise ValueError(f"fused_dynamic_filter: unsupported device "
                         f"{net_conv.device}")
    if gate not in ("sigmoid", "multiply"):
        raise ValueError(f"fused_dynamic_filter: unknown gate {gate!r}")
    if net_conv.dim() != 4 or net_conv.dtype not in (torch.bfloat16,
                                                     torch.float32):
        raise ValueError("fused_dynamic_filter: net_conv must be (E, H, W, "
                         "C) bfloat16 or float32")
    e, h, w, c = net_conv.shape
    k = num_filters
    per_vec = 8 if net_conv.dtype == torch.bfloat16 else 4
    nv = c // (32 * per_vec)
    if k not in (1, 7) or c % (32 * per_vec) or nv not in (
            (1, 2, 4) if per_vec == 8 else (1, 2, 4, 8)):
        raise ValueError(f"fused_dynamic_filter: unsupported C={c}, K={k} "
                         f"for {net_conv.dtype}")
    s0, s1, s2, s3 = net_conv.stride()
    if (s1, s2, s3) != (w * c, c, 1):
        raise ValueError("fused_dynamic_filter: each (H, W, C) map must be "
                         "contiguous")
    if net_conv.data_ptr() % 16 or (s0 * net_conv.element_size()) % 16:
        raise ValueError("fused_dynamic_filter: net_conv must be 16-byte "
                         "aligned")
    for name, t, shape in (("filt", filt, (e, c, k)), ("rfilt", rfilt, (e, k))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != net_conv.device):
            raise ValueError(f"fused_dynamic_filter: {name} must be a "
                             f"contiguous float32 {shape} on the map's device")

    gated = torch.empty((e, h, w, c), dtype=net_conv.dtype,
                        device=net_conv.device)
    resp = torch.empty((e, h, w, 1), dtype=torch.float32,
                       device=net_conv.device)
    scale = 1.0 / (c ** 0.5) if normalize else 1.0
    stream = torch.cuda.current_stream(net_conv.device).cuda_stream
    rc = _lib().fused_filter_launch(
        net_conv.data_ptr(), s0, filt.data_ptr(), rfilt.data_ptr(), e, h, w,
        c, k, int(net_conv.dtype == torch.bfloat16), int(gate == "sigmoid"),
        scale, gated.data_ptr(), resp.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_filter kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return gated, resp
