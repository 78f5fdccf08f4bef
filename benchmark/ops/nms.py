"""NMS, timed at the program's entry `ops/proposals.py::nms_batched`;
its bound from the call's boxes and its kept indices."""

from benchmark.bounds import nms

ENTRY = ("lang2seg_tpu_torch.ops.proposals", "nms_batched")


def keep(args, kwargs, out):
    """What the bound reads: the lanes, boxes and slots, and the kept
    indices and mask (device tensors, read after the window)."""
    boxes, _, _, max_out = args[:4]
    return boxes.shape[0], boxes.shape[1], max_out, out[0], out[1]


def bound_s(rec) -> float:
    e, n, max_out, keep_idx, keep_mask = rec
    return nms.bound_s(e, n, max_out, keep_idx.cpu().numpy(),
                       keep_mask.cpu().numpy().astype(bool))
