"""Device selection for the port's entry points, and small constants
kept on a device."""

from __future__ import annotations

import functools
from typing import Tuple

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on. "cuda" (the default of
    every entry point) raises when no card is present: the serving path
    is meant for the card, and the CPU is taken only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lang2seg_tpu_torch: device='cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def _constant(values: Tuple[float, ...], device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def device_constant(values, device) -> torch.Tensor:
    """A small f32 constant (pixel means, box normalisers) on `device`,
    copied there once and shared by every later caller, which must not
    write to it. A copy from pageable host memory synchronises the host
    with the stream, so a training step copies nothing."""
    return _constant(tuple(float(v) for v in values), str(device))
