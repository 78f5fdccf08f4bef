"""Greedy non-maximum suppression in plain PyTorch, batched over lanes.

Counterpart of `lang2seg_tpu/ops/nms.py::nms_padded` (and of the batched
Pallas kernel `ops/nms_pallas.py::nms_pallas_batched`), with their wire
format: keep_idx (E, max_out) int32, 0 in padded slots, and keep_mask
(E, max_out) bool. It is the plain version of the CUDA kernel in
`nms_cuda.py`: the CPU path of the port, and the version the kernel is
held against on the card, bit for bit.

The algorithm is the textbook greedy pass in index (= score) order over
a precomputed suppression matrix: simple rather than fast.
"""

from __future__ import annotations

import torch

from .boxes import box_iou

_ROW_CHUNK = 1024   # rows of the IoU matrix formed at once (bounds memory)


def suppression_matrix(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """(E, N, N) bool: [e, i, j] iff j > i and IoU(i, j) > iou_thresh,
    compared in f32 against the f32 threshold (as the reference does)."""
    e, n, _ = boxes.shape
    thresh = torch.tensor(iou_thresh, dtype=torch.float32,
                          device=boxes.device)
    sup = torch.empty((e, n, n), dtype=torch.bool, device=boxes.device)
    for r0 in range(0, n, _ROW_CHUNK):
        rows = boxes[:, r0:r0 + _ROW_CHUNK]
        sup[:, r0:r0 + rows.shape[1]] = box_iou(rows, boxes) > thresh
    return torch.triu(sup, diagonal=1)


def nms_padded(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
               max_out: int):
    """Greedy NMS over score-sorted boxes, per lane.

    boxes: (E, N, 4) f32 [x1 y1 x2 y2], sorted by descending score;
    valid: (E, N) bool (invalid boxes are never kept and suppress
    nothing); a box is suppressed iff IoU > iou_thresh with an earlier
    kept box. Returns (keep_idx (E, max_out) int32, keep_mask (E,
    max_out) bool): the first max_out kept indices in order, 0-padded."""
    e, n, _ = boxes.shape
    dev = boxes.device
    sup = suppression_matrix(boxes.float(), iou_thresh)
    removed = ~valid.to(torch.bool)
    keep = torch.zeros((e, n), dtype=torch.bool, device=dev)
    for i in range(n):
        k = ~removed[:, i]
        keep[:, i] = k
        removed |= sup[:, i] & k[:, None]

    pos = torch.where(keep, torch.cumsum(keep.to(torch.int64), 1) - 1,
                      max_out).clamp(max=max_out)
    slots = torch.zeros((e, max_out + 1), dtype=torch.int32, device=dev)
    ranks = torch.arange(n, dtype=torch.int32, device=dev).expand(e, n)
    # kept boxes land on distinct slots < max_out in order; every other box
    # goes to the spare slot max_out, which is dropped
    slots.scatter_(1, pos, ranks)
    total = keep.sum(1).clamp(max=max_out)
    keep_mask = (torch.arange(max_out, device=dev)[None, :]
                 < total[:, None])
    keep_idx = torch.where(keep_mask, slots[:, :max_out], 0)
    return keep_idx, keep_mask
