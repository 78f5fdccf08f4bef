"""Batched greedy NMS: the hand-written CUDA kernel (`csrc/nms.cu`) for
CUDA tensors, its plain PyTorch version (`nms.nms_padded`) for CPU
tensors.

Replaces the TPU kernel `lang2seg_tpu/ops/nms_pallas.py::
nms_pallas_batched`; same wire format (see `nms.py`). The kernel is one
launch with no device scratch: a thread-block cluster per lane walks the
boxes in tiles of 64 against a frontier of kept boxes in shared memory.
Each launch counts `nms.launches` (`utils/trace.py`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.trace import count, span
from . import _build
from .nms import nms_padded


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("nms")
    p = ctypes.c_void_p
    lib.nms_launch.argtypes = [p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, ctypes.c_int, p, p, p]
    lib.nms_launch.restype = ctypes.c_int
    lib.nms_cluster_size.argtypes = [ctypes.c_int] * 3
    lib.nms_cluster_size.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _cluster_size(device_index: int, e: int, cap: int) -> int:
    with torch.cuda.device(device_index):
        c = _lib().nms_cluster_size(e, cap, cap)
    if c < 1:
        raise RuntimeError(f"nms cluster occupancy query failed: "
                           f"cudaError {-c}")
    return c


def cluster_size(device: torch.device, e: int, n: int, max_out: int) -> int:
    """CTAs per lane: the largest cluster (at most 8) of which the card
    can hold all E at once, one CTA per SM, as
    `cudaOccupancyMaxActiveClusters` reports it for the launch of E lanes
    with a frontier of min(max_out, N) boxes; 1 where none fits. More
    CTAs split each tile's frontier test further, but a lane that waits
    for SMs costs a whole second pass (on an H100 SXM, 6 for E = 16, 8
    for E <= 15)."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return _cluster_size(index, e, min(max_out, n))


def _launch(boxes, valid, iou_thresh, max_out, cluster):
    e, n, _ = boxes.shape
    keep_idx = torch.empty((e, max_out), dtype=torch.int32,
                           device=boxes.device)
    keep_mask = torch.empty((e, max_out), dtype=torch.bool,
                            device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    with torch.cuda.device(boxes.device):     # the stream's device
        rc = _lib().nms_launch(boxes.data_ptr(), valid.data_ptr(), e, n,
                               max_out, float(iou_thresh), cluster,
                               keep_idx.data_ptr(), keep_mask.data_ptr(),
                               stream)
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError {rc}")
    count("nms.launches")
    return keep_idx, keep_mask


@span("l2s.nms")
def nms_batched(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                max_out: int):
    """boxes (E, N, 4) f32 score-sorted, valid (E, N) bool ->
    (keep_idx (E, max_out) int32, keep_mask (E, max_out) bool).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream (`cluster_size` CTAs per lane), or
    raises."""
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
    return _launch(boxes, valid, iou_thresh, max_out,
                   cluster_size(boxes.device, e, n, max_out))
