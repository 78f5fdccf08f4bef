"""Model FLOPs of the work completed in the traced window (counted from
the cell's shapes with the reference, `benchmark/flops/`) over the
window and the H100's dense bf16 peak."""

from benchmark.bounds.peaks import BF16_FLOPS


def read(view):
    s = view["summary"]
    if not view["flops"] or s.window_s <= 0:
        return None
    return 100.0 * view["flops"] / s.window_s / BF16_FLOPS
