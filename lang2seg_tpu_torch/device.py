"""Device selection for the port's entry points, small constants kept
on a device, and the capture of a CUDA graph."""

from __future__ import annotations

import collections
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch

from .utils import trace


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


def capture_graph(fn: Callable, pool=None, generators: Sequence = (),
                  warm: Optional[Callable] = None
                  ) -> Tuple["torch.cuda.CUDAGraph", object,
                             collections.Counter]:
    """Captures `fn()` as a CUDA graph on the current device: on a side
    stream that waits on the current one (after `warm()` there, if
    given), in `pool` (a new one if None), with `generators` registered,
    capture errors thread-local (other threads may copy or pin memory
    meanwhile); the current stream waits on the side stream after.
    Returns (graph, fn's output, the capture's record): the capture runs
    no kernel, so its counts go to the record (`utils/trace.py`), which
    each replay adds with `trace.add`."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    if warm is not None:
        with torch.cuda.stream(side):
            warm()
    with trace.recording() as record, torch.cuda.graph(
            graph, pool=pool, stream=side, capture_error_mode="thread_local"):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return graph, out, record
