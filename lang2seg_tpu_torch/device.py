"""Device selection for the port's entry points, small constants kept
on a device, the capture of a CUDA graph, and the replay of a module's
inference pass as one graph an input key (`GraphedPasses`)."""

from __future__ import annotations

import collections
import functools
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

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


class Graphed(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    static_in: Tuple[torch.Tensor, ...]
    static_out: object            # a tensor or a tuple of tensors
    # the counts of the captured pass, which each replay adds: it runs the
    # kernels without their wrappers
    record: collections.Counter


class GraphedPasses:
    """A pass over `modules` captured as a CUDA graph for each input key
    (the inputs' shapes, dtypes and device), all in one memory pool (they
    replay on one stream, one at a time), and what a replay must find
    unchanged: the caller's `reads`, which hold the address of every
    parameter and buffer of `modules` (`addresses`). A replay runs the same
    kernels on the same addresses, so it gives the eager pass's bits and
    reads the weights as they are then: an in-place update is seen, a
    re-bind to other storage changes the reads and drops the graphs. Counts
    `<name>.graph_captures`, `_replays` and `_eager` (`utils/trace.py`)."""

    def __init__(self, modules: Sequence[torch.nn.Module], name: str):
        slots = [(d, k) for mod in modules for m in mod.modules()
                 for d in (m._parameters, m._buffers)
                 for k, t in d.items() if t is not None]
        self.dicts, self.names = zip(*slots)
        self.captures, self.replays, self.eager = (
            f"{name}.graph_{what}" for what in ("captures", "replays",
                                                "eager"))
        self.by_key: Dict[tuple, Graphed] = {}
        self.reads = None
        self.pool = None

    def addresses(self) -> tuple:
        """The data_ptr of every parameter and buffer, as bound now (~50 us
        on the host for 470 tensors)."""
        return tuple(map(torch.Tensor.data_ptr, map(
            dict.__getitem__, self.dicts, self.names)))

    def drop(self) -> None:
        for hit in self.by_key.values():
            torch.cuda.synchronize(hit.static_in[0].device)   # no replay
        self.by_key.clear()
        self.pool = None

    def run(self, fn: Callable, inputs: Tuple[torch.Tensor, ...],
            reads: tuple, cap: int):
        """fn(*inputs) by the graph captured at the inputs' key, capturing
        it first if need be: copies the inputs in, replays, and returns a
        copy of the output (a tensor or a tuple of tensors), so an earlier
        call's result is never overwritten. Drops every graph first if
        `reads` differ from the last call's; past `cap` keys, runs
        fn(*inputs) eager and counts `<name>.graph_eager`."""
        if reads != self.reads:
            self.drop()
            self.reads = reads
        key = tuple((x.shape, x.dtype, x.device) for x in inputs)
        hit = self.by_key.get(key)
        if hit is None:
            if len(self.by_key) >= cap:
                trace.count(self.eager)
                return fn(*inputs)
            hit = self.by_key[key] = self._capture(fn, inputs)
        for static, x in zip(hit.static_in, inputs):
            static.copy_(x)
        hit.graph.replay()
        trace.count(self.replays)
        trace.add(hit.record)
        out = hit.static_out
        if isinstance(out, tuple):
            return tuple(t.clone() for t in out)
        return out.clone()

    def _capture(self, fn: Callable, inputs: Tuple[torch.Tensor, ...]
                 ) -> Graphed:
        """fn at the inputs' key as a CUDA graph in the pool
        (`capture_graph`), after an eager pass on the side stream (cuDNN
        and cuBLAS choose their algorithms, the kernels' launch state is
        cached), which counts as the pass it is; the capture counts
        nothing."""
        with torch.cuda.device(inputs[0].device):
            static_in = tuple(torch.empty_like(
                x, memory_format=torch.contiguous_format).copy_(x)
                for x in inputs)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            call = functools.partial(fn, *static_in)
            graph, out, record = capture_graph(call, pool=self.pool,
                                               warm=call)
        trace.count(self.captures)
        return Graphed(graph, static_in, out, record)
