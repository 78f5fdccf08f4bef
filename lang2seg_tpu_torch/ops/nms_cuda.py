"""Batched greedy NMS: the hand-written CUDA kernel (`csrc/nms.cu`) for
CUDA tensors, its plain PyTorch version (`nms.nms_padded`) for CPU
tensors.

Replaces the TPU kernel `lang2seg_tpu/ops/nms_pallas.py::
nms_pallas_batched`; same wire format (see `nms.py`). `launches` counts
the kernel's launches (the two-pass kernel counts once per call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .nms import nms_padded

launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("nms")
    p = ctypes.c_void_p
    lib.nms_launch.argtypes = [p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, p, p, p, p]
    lib.nms_launch.restype = ctypes.c_int
    return lib


def nms_batched(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                max_out: int):
    """boxes (E, N, 4) f32 score-sorted, valid (E, N) bool ->
    (keep_idx (E, max_out) int32, keep_mask (E, max_out) bool).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream, or raises."""
    if boxes.device.type == "cpu":
        return nms_padded(boxes, valid, iou_thresh, max_out)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_batched: unsupported device {boxes.device}")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"nms_batched: boxes must be (E, N, 4) float32, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    e, n, _ = boxes.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (e, n) \
            or valid.device != boxes.device:
        raise ValueError("nms_batched: valid must be (E, N) bool on the "
                         "boxes' device")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_batched: boxes and valid must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_batched: boxes must be 16-byte aligned")
    if max_out <= 0:
        raise ValueError("nms_batched: max_out must be positive")

    col_blocks = (n + 63) // 64
    # the kernel's suppression bitmask; freed when this returns, which is
    # safe: the caching allocator hands the block out again only to work
    # queued after the kernel on the same stream
    scratch = torch.empty(max(e * n * col_blocks, 1), dtype=torch.int64,
                          device=boxes.device)
    keep_idx = torch.empty((e, max_out), dtype=torch.int32,
                           device=boxes.device)
    keep_mask = torch.empty((e, max_out), dtype=torch.bool,
                            device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    rc = _lib().nms_launch(boxes.data_ptr(), valid.data_ptr(), e, n, max_out,
                           float(iou_thresh), scratch.data_ptr(),
                           keep_idx.data_ptr(), keep_mask.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return keep_idx, keep_mask
