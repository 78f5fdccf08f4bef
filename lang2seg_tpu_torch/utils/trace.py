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

`count(name, n, key)` adds to a process-wide integer counter, always
on, and with a `key` also to that key's count under the name;
`counters()` is a snapshot of the totals, `by_key(name)` of one name's
counts by key:

  eval.h2d_bytes          bytes the evaluator has copied to the device
  eval.images             images the evaluator has dispatched
  vgg.fc_rows             rows (ROIs) VGG16's fc6 / fc7 stack has taken
  nms.launches            NMS kernels run (`ops/nms_cuda.py`)
  gate.launches           the gate's forward kernels run
                          (`ops/fused_filter.py`)
  gate.bwd_launches       its backward kernels run
  roi_crop.launches       ROI crop forward kernels run, by `shape_key`
                          (`ops/roi_crop_cuda.py`)
  roi_crop.bwd_launches   its backward kernels run, by `shape_key`
  roi_pool.launches       ROI pool forward kernels run, by `shape_key`
                          (`ops/roi_pool_cuda.py`)
  roi_pool.bwd_launches   its backward kernels run, by `shape_key`
  bn_act.launches         frozen-BatchNorm forward kernels run, by
                          `shape_key` (`ops/bn_act_cuda.py`)
  bn_act.bwd_launches     its backward kernels run, by `shape_key`
  backbone.graph_captures ResNet heads captured as a CUDA graph
                          (`models/resnet.py`)
  backbone.graph_replays  head calls that replayed one (no gradient, on
                          the card)
  backbone.graph_eager    such calls that ran eager instead: past the cap
                          on captured shapes
  condition.graph_captures, condition.graph_replays, condition.graph_eager
                          the same for the language half of the
                          conditioning, a graph a label shape
                          (`models/network.py::Lang2Seg._filters`)

A graph's hit share is replays / (replays + eager).

A launch counter counts the kernels the device ran. A CUDA graph's
capture runs none: it counts inside `recording()`, whose record the
graph keeps, and each replay adds that record to the counters (`add`,
`device.capture_graph`). A recording is the calling thread's own, with
the backward passes autograd runs meanwhile on its device threads:
counts made on other threads go to the counters as always.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
from typing import Callable, Dict, Hashable, Iterator, List, Optional

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
_keyed: Dict[str, Dict[Hashable, int]] = {}
# the recording open on each thread, if any, and every open recording
# (newest last)
_local = threading.local()
_recordings: List[collections.Counter] = []


def count(name: str, n: int = 1, key: Optional[Hashable] = None) -> None:
    """Adds n to the counter `name` and, given a `key`, to that key's
    count under it; inside `recording()`, to its record instead."""
    record = getattr(_local, "record", None)
    # a backward on one of autograd's threads counts in the newest record
    if record is None and _recordings and \
            torch._C._current_graph_task_id() >= 0:
        record = _recordings[-1]
    if record is not None:
        record[name, key] += n
        return
    _counts[name] = _counts.get(name, 0) + n
    if key is not None:
        per = _keyed.setdefault(name, {})
        per[key] = per.get(key, 0) + n


def counters() -> Dict[str, int]:
    return dict(_counts)


def by_key(name: str) -> Dict[Hashable, int]:
    """The counts of `name` by key (the counts made with one)."""
    return dict(_keyed.get(name, {}))


@contextlib.contextmanager
def recording() -> Iterator[collections.Counter]:
    """Counts made inside the block go into the record it yields, (name,
    key) -> n, and not into the counters: those of the calling thread,
    and those of a backward pass run meanwhile on a thread with no
    recording of its own (autograd runs a CUDA node's backward on its
    device's thread). Other threads count as always."""
    outer = getattr(_local, "record", None)
    _local.record = record = collections.Counter()
    _recordings.append(record)
    try:
        yield record
    finally:
        _recordings.remove(record)
        _local.record = outer


def add(record: collections.Counter, times: int = 1) -> None:
    """Adds `times` x a record's counts to the counters (or to the
    recording open here)."""
    for (name, key), n in record.items():
        count(name, n * times, key)
