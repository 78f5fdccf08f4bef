"""The least time a stack of dense layers could take on a call's rows:
each layer's 2 * rows * in * out f32 operations against the f32 peak of
the CUDA cores (no tensor cores: TF32 is off), or its f32 weights and
bias, its input and its output, each read or written once, against HBM
bandwidth; the larger of the two sums. A layer is (rows, in, out)."""

from __future__ import annotations

from typing import Sequence, Tuple

from .peaks import F32_FLOPS, HBM_BYTES_PER_S

Layer = Tuple[int, int, int]


def flops(layers: Sequence[Layer]) -> int:
    return sum(2 * r * i * o for r, i, o in layers)


def bytes_moved(layers: Sequence[Layer]) -> int:
    return sum(4 * (i * o + o + r * i + r * o) for r, i, o in layers)


def bound_s(layers: Sequence[Layer]) -> float:
    return max(flops(layers) / F32_FLOPS,
               bytes_moved(layers) / HBM_BYTES_PER_S)
