"""The ROI crop backward, timed at the program's entry
`ops/roi_crop_cuda.py::roi_crop_backward`; its bound from the call's
gradient and map extent."""

from benchmark.bounds import crop

ENTRY = ("lang2seg_tpu_torch.ops.roi_crop_cuda", "roi_crop_backward")


def keep(args, kwargs, out):
    grad, ys, xs, h, w = args[:5]
    return tuple(grad.shape), grad.element_size(), h, w


def bound_s(rec) -> float:
    shape, elem, h, w = rec
    return crop.backward_bound_s(shape, elem, h, w)
