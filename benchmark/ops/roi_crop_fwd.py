"""The ROI crop forward, timed at the program's entry
`ops/roi_crop_cuda.py::roi_crop_forward`; its bound from the call's map
and sample coordinates."""

from benchmark.bounds import crop

ENTRY = ("lang2seg_tpu_torch.ops.roi_crop_cuda", "roi_crop_forward")


def keep(args, kwargs, out):
    """The map's shape, element size and broadcast, and the (small)
    sample coordinates."""
    feat, ys, xs = args[:3]
    return (tuple(feat.shape), feat.element_size(), feat.stride(0) == 0,
            ys, xs)


def bound_s(rec) -> float:
    shape, elem, broadcast, ys, xs = rec
    return crop.forward_bound_s(shape, elem, broadcast, ys, xs)
