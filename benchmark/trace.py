"""The traced run: a `torch.profiler` trace of the window, kept in memory,
reduced to what the per-layer metrics read.

* `busy_s`: the union of the device intervals (kernels, copies, fills) on
  every stream, clipped to the window; `window_s` the window's length.
* an op's device time: every device launch made inside a
  `record_function` range that `OpTimer` opens around one of the
  program's op entry points, whatever the launch is named. A device event
  is tied to the host call that launched it by the profiler's correlation
  ids: the runtime call (`cudaLaunchKernel` and kin, the same id), or
  else the host op it is linked to (`linked_correlation_id`).
* the breakdown: the device operations that took the most time, and the
  longest idle gaps, each named by the innermost host range open when it
  began.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "bench.window"
OP_PREFIX = "bench.op."


@dataclass
class Ev:
    name: str
    start: int          # ns
    end: int
    tid: int
    corr: int
    linked: int
    annotation: bool = False


def _ns(ev, what: str) -> int:
    if hasattr(ev, f"{what}_ns"):
        return int(getattr(ev, f"{what}_ns")())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _events(prof) -> Tuple[List[Ev], List[Ev]]:
    """(host events, device events) of a finished profile."""
    from torch.autograd import DeviceType
    host, dev = [], []
    for k in prof.profiler.kineto_results.events():
        start = _ns(k, "start")
        end = start + _ns(k, "duration")
        kind = str(getattr(k, "activity_type", lambda: "")()).lower()
        e = Ev(k.name(), start, end, int(k.start_thread_id()),
               int(k.correlation_id()), int(k.linked_correlation_id()),
               "annotation" in kind or k.name().startswith("bench."))
        (host if k.device_type() == DeviceType.CPU else dev).append(e)
    return host, dev


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    op_device_s: Dict[str, float] = field(default_factory=dict)
    op_launches: Dict[str, int] = field(default_factory=dict)
    device_ops: List[List] = field(default_factory=list)
    idle_gaps: List[List] = field(default_factory=list)


def summarize(prof, top: int = 10) -> TraceSummary:
    host, dev = _events(prof)
    windows = [e for e in host if e.name == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window range")
    w = windows[0]
    # device events that mirror host ranges on the device's timeline are
    # not device work
    work = [e for e in dev if not e.annotation and e.end > e.start]
    clipped = [(max(e.start, w.start), min(e.end, w.end)) for e in work
               if e.end > w.start and e.start < w.end]
    busy = _union(clipped)
    busy_ns = sum(e - s for s, e in busy)

    by_name: Dict[str, int] = defaultdict(int)
    for e in work:
        if e.end > w.start and e.start < w.end:
            by_name[e.name] += min(e.end, w.end) - max(e.start, w.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # op ranges, and the host event that launched each device event
    ranges: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    for e in host:
        if e.name.startswith(OP_PREFIX):
            ranges[e.tid].append((e.start, e.end, e.name[len(OP_PREFIX):]))
    for r in ranges.values():
        r.sort()
    runtime_by_corr = {e.corr: e for e in host
                       if e.name.startswith(("cuda", "cu")) and e.corr}
    ops_by_corr = {e.corr: e for e in host if e.linked == 0
                   and not e.name.startswith(("cuda", "cu"))}

    starts = {tid: [r[0] for r in rs] for tid, rs in ranges.items()}

    def op_of(launcher: Optional[Ev]) -> Optional[str]:
        """The op range open at the launch on its thread (op ranges do not
        nest)."""
        if launcher is None or launcher.tid not in ranges:
            return None
        i = bisect.bisect_right(starts[launcher.tid], launcher.start) - 1
        if i < 0:
            return None
        s, t, name = ranges[launcher.tid][i]
        return name if launcher.start <= t else None

    op_s: Dict[str, float] = defaultdict(float)
    op_n: Dict[str, int] = defaultdict(int)
    for e in work:
        if not (w.start <= e.start < w.end):
            continue
        name = op_of(runtime_by_corr.get(e.corr)) or \
            op_of(ops_by_corr.get(e.linked))
        if name is not None:
            op_s[name] += (e.end - e.start) * 1e-9
            op_n[name] += 1

    # idle gaps inside the window, named by the innermost host range
    # open at the gap's start on any thread that has ranges then
    edges = [w.start] + [x for iv in busy for x in iv] + [w.end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = sorted(((e.start, e.end, e.name) for e in host
                    if e.name != WINDOW and e.end > e.start),
                   key=lambda s: s[0])
    span_starts = [s[0] for s in spans]
    idle = []
    for s, t in gaps[:top]:
        i = bisect.bisect_right(span_starts, s)
        inner = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            a, b, name = spans[j]
            if b > s and (inner is None or b - a < inner[1] - inner[0]):
                inner = (a, b, name)
        idle.append([inner[2] if inner else "(no host range)",
                     (t - s) * 1e-9])
    return TraceSummary(
        window_s=(w.end - w.start) * 1e-9, busy_s=busy_ns * 1e-9,
        op_device_s=dict(op_s), op_launches=dict(op_n),
        device_ops=[[n, ns * 1e-9] for n, ns in device_ops], idle_gaps=idle)


class OpTimer:
    """Wraps a program's op entry points (module attributes) in
    `record_function` ranges named `bench.op.<name>`, and keeps what each
    call's bound reads (`keep(args, kwargs, out)`, small) while
    `recording`. `undo` puts the originals back."""

    def __init__(self):
        self.recording = False
        self.calls: Dict[str, List] = defaultdict(list)
        self._undo: List[Callable] = []

    def wrap(self, module, attr: str, name: str, keep: Callable) -> None:
        import torch
        orig = getattr(module, attr)

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(OP_PREFIX + name):
                out = orig(*args, **kwargs)
            if self.recording:
                self.calls[name].append(keep(args, kwargs, out))
            return out

        setattr(module, attr, wrapped)
        self._undo.append(lambda: setattr(module, attr, orig))

    def undo(self) -> None:
        while self._undo:
            self._undo.pop()()
