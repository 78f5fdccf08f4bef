"""Spans and counters of the program.

`span(name)` marks a stretch of host time as a range of the
`torch.profiler` trace, on the clock of the device's kernels and copies:
`with span("l2s.upload"): ...` or `@span("l2s.request")`. While no
profiler collects, a span reads one flag and returns a null context
shared by every span of that name: nothing reaches the dispatcher, and
there is no second clock or in-memory log. A range opened on a thread the
profiler does not follow (a Python worker thread, unless the profiler was
started with `profile_all_threads`) leaves nothing in the trace.

Names: `l2s.<layer>` for the program's own work, `l2s.sync.<what>` for a
host wait on the device, `l2s.wait.<what>` for a host wait on another
host thread.

`count(name, n)` adds to a process-wide integer counter, always on;
`counters()` is a snapshot of them all:

  eval.h2d_bytes          bytes the evaluator has copied to the device
  eval.images             images the evaluator has dispatched
  vgg.fc_rows             rows (ROIs) VGG16's fc6 / fc7 stack has taken
  bn_act.launches         frozen-BatchNorm forward kernels run: the
                          wrapper's launches and the ResNet head's graph
                          replays' (`ops/bn_act_cuda.py`)
  bn_act.bwd_launches     its backward kernels run
  backbone.graph_captures ResNet heads captured as a CUDA graph
                          (`models/resnet.py`)
  backbone.graph_replays  head calls that replayed one (no gradient, on
                          the card)
  backbone.graph_eager    such calls that ran eager instead: past the cap
                          on captured shapes

The head graph's hit share is replays / (replays + eager).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch
from torch.autograd import profiler as _profiler

# the range a span opens while a profiler collects: a RecordFunction
# entered without the dispatcher's argument handling
_open = torch._C._profiler._RecordFunctionFast


class _Null:
    """The null context of one span name; as a decorator it opens the
    span anew at each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


_nulls: Dict[str, _Null] = {}


def span(name: str):
    """A context manager (and, applied to a function, a decorator) that
    records `name` as a profiler range while a profiler collects."""
    if _profiler._is_profiler_enabled:
        return _open(name)
    null = _nulls.get(name)
    if null is None:
        null = _nulls.setdefault(name, _Null(name))
    return null


_counts: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    return dict(_counts)
