"""The program's own spans in the traced window: its `l2s.*` ranges
(`lang2seg_tpu_torch/utils/trace.py`) reduced against the device events
of the same `torch.profiler` trace.

* A device launch (kernel, copy or fill starting in the window) is
  assigned to the innermost `l2s.` span open at its runtime call (the
  correlation id, as `trace.summarize` ties them) on the call's thread;
  where none is open there, to the innermost one open at that moment on
  the program thread, the thread that holds the window's range (the
  autograd engine's thread launches the backward). A span's own device
  time and launches are those assigned to it; its inclusive device time
  adds its descendants' on its thread.
* The device's idle time in the window splits three ways by what the
  program thread does meanwhile: inside an `l2s.` span but not an
  `l2s.sync.` one (host-bound), inside an `l2s.sync.` span (a wait on the
  device), or outside every `l2s.` span. The three add up to the idle
  share.
* Runtime calls (kernel, copy, fill and graph launches) on any thread
  are counted inside a span's intervals, for launches a request or step.
* The longest idle gaps are named by the innermost span open on the
  program thread when each began.

A program without spans gives a view without spans (`has_spans` False).

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

makes one traced run of the cell (`benchmark.run --trace 1`, the same
result line) and prints the view as one more line on standard error:
the idle split, the program's counters' change over the window, and
every span name's calls, host ms, device ms and launches.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import WINDOW, Ev, _events, _union

PREFIX = "l2s."
SYNC = "l2s.sync."
# runtime calls that put work on the device
RUNTIME = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                     r"GraphLaunch|Memcpy|Memset)")


# what the view keeps of each span name
BLANK = {"calls": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": 0.0,
         "device_incl_ms": 0.0, "launches": 0}


@dataclass
class _Span:
    name: str
    start: int
    end: int
    tid: int
    parent: Optional["_Span"] = None
    children_ns: int = 0
    device_ns: int = 0
    launches: int = 0


@dataclass
class SpanView:
    window_s: float
    idle_pct: float
    host_bound_idle_pct: float
    sync_idle_pct: float
    outside_idle_pct: float
    has_spans: bool
    # per span name: calls, host_ms, self_ms, device_ms (own),
    # device_incl_ms, launches (own device launches)
    by_name: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # per span name: runtime calls starting inside its intervals
    runtime_calls: Dict[str, int] = field(default_factory=dict)
    # the longest idle gaps, each named by the innermost span open on the
    # program thread when it began: [[name, seconds], ...]
    idle_gaps: List[List] = field(default_factory=list)

    def calls(self, name: str) -> int:
        return int(self.by_name.get(name, {}).get("calls", 0))

    def get(self, name: str, key: str) -> float:
        return self.by_name.get(name, {}).get(key, 0.0)


def _overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Total length of the intersection of two sorted disjoint interval
    lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _nest(spans: List[_Span]) -> None:
    """Parents and children's time of one thread's spans, sorted by
    start (the outer first at equal starts)."""
    stack: List[_Span] = []
    for s in spans:
        while stack and stack[-1].end <= s.start:
            stack.pop()
        if stack:
            s.parent = stack[-1]
            stack[-1].children_ns += s.end - s.start
        stack.append(s)


class _Threads:
    """Each thread's spans, for the innermost one open at a moment."""

    def __init__(self, spans: List[_Span]):
        self.by_tid: Dict[int, List[_Span]] = defaultdict(list)
        for s in spans:
            self.by_tid[s.tid].append(s)
        self.starts: Dict[int, List[int]] = {}
        for tid, ss in self.by_tid.items():
            ss.sort(key=lambda s: (s.start, -s.end))
            _nest(ss)
            self.starts[tid] = [s.start for s in ss]

    def innermost(self, tid: int, t: int) -> Optional[_Span]:
        ss = self.by_tid.get(tid)
        if not ss:
            return None
        i = bisect.bisect_right(self.starts[tid], t) - 1
        s = ss[i] if i >= 0 else None
        while s is not None and s.end <= t:
            s = s.parent
        return s


def reduce(host: Sequence[Ev], dev: Sequence[Ev]) -> SpanView:
    """The view of a trace's host and device events (`trace._events`)."""
    windows = [e for e in host if e.name == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window range")
    w = windows[0]
    program = w.tid
    spans = [_Span(e.name, e.start, e.end, e.tid) for e in host
             if e.name.startswith(PREFIX) and e.end > e.start]
    threads = _Threads(spans)

    work = [e for e in dev if not e.annotation and e.end > e.start]
    busy = _union([(max(e.start, w.start), min(e.end, w.end)) for e in work
                   if e.end > w.start and e.start < w.end])
    win = [(w.start, w.end)]
    idle_ns = (w.end - w.start) - _overlap(busy, win)

    runtime_by_corr = {e.corr: e for e in host
                       if e.name.startswith(("cuda", "cu")) and e.corr}
    ops_by_corr = {e.corr: e for e in host if e.linked == 0
                   and not e.name.startswith(("cuda", "cu"))}
    for e in work:
        if not (w.start <= e.start < w.end):
            continue
        launcher = runtime_by_corr.get(e.corr) or ops_by_corr.get(e.linked)
        if launcher is None:
            continue
        s = threads.innermost(launcher.tid, launcher.start) or \
            threads.innermost(program, launcher.start)
        if s is not None:
            s.device_ns += e.end - e.start
            s.launches += 1

    in_window = [s for s in spans if w.start <= s.start < w.end]
    by_name: Dict[str, Dict[str, float]] = {}
    for s in in_window:
        d = by_name.setdefault(s.name, dict(BLANK))
        d["calls"] += 1
        d["host_ms"] += (s.end - s.start) * 1e-6
        d["self_ms"] += (s.end - s.start - s.children_ns) * 1e-6
        d["device_ms"] += s.device_ns * 1e-6
        d["launches"] += s.launches
        # inclusive: the span's own and each enclosing name's, once a name
        names = set()
        a: Optional[_Span] = s
        while a is not None:
            if a.name not in names:
                names.add(a.name)
                by_name.setdefault(a.name, dict(BLANK))[
                    "device_incl_ms"] += s.device_ns * 1e-6
            a = a.parent

    # the program thread's spans, and its waits on the device
    mine = threads.by_tid.get(program, [])
    clip = [(max(s.start, w.start), min(s.end, w.end), s.name) for s in mine
            if s.end > w.start and s.start < w.end]
    inside = _union([(a, b) for a, b, _ in clip])
    syncing = _union([(a, b) for a, b, n in clip if n.startswith(SYNC)])
    idle = _gaps(busy, w.start, w.end)
    sync_ns = _overlap(idle, syncing)
    host_ns = _overlap(idle, inside) - sync_ns
    outside_ns = idle_ns - host_ns - sync_ns

    # runtime calls on any thread inside each name's intervals
    calls = sorted(e.start for e in host if RUNTIME.match(e.name)
                   and w.start <= e.start < w.end)
    runtime_calls: Dict[str, int] = defaultdict(int)
    for name in {s.name for s in in_window}:
        for a, b in _union([(s.start, s.end) for s in in_window
                            if s.name == name]):
            runtime_calls[name] += (bisect.bisect_left(calls, b)
                                    - bisect.bisect_left(calls, a))

    longest = sorted(idle, key=lambda g: g[0] - g[1])[:10]
    named = [threads.innermost(program, a) for a, _ in longest]
    gaps = [[n.name if n is not None else "(outside)", (b - a) * 1e-9]
            for n, (a, b) in zip(named, longest)]

    win_ns = max(w.end - w.start, 1)
    return SpanView(
        window_s=(w.end - w.start) * 1e-9,
        idle_pct=100.0 * idle_ns / win_ns,
        host_bound_idle_pct=100.0 * host_ns / win_ns,
        sync_idle_pct=100.0 * sync_ns / win_ns,
        outside_idle_pct=100.0 * outside_ns / win_ns,
        has_spans=bool(in_window), by_name=by_name,
        runtime_calls=dict(runtime_calls), idle_gaps=gaps)


def _gaps(busy: List[Tuple[int, int]], lo: int, hi: int
          ) -> List[Tuple[int, int]]:
    """[lo, hi) less the sorted disjoint intervals of `busy`."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def from_profile(prof) -> SpanView:
    return reduce(*_events(prof))


def counters() -> Dict[str, int]:
    """The program's counters (`utils/trace.py::counters`); none from a
    program without them."""
    try:
        from lang2seg_tpu_torch.utils.trace import counters as read
    except ImportError:
        return {}
    return read()


def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def line(view: SpanView, counts: Dict[str, int]) -> str:
    """The stderr line: the idle split, the counters' change over the
    window, then every span name's calls, host ms (total / self), device
    ms (own / inclusive), own launches and the runtime calls made inside
    it on any thread."""
    parts = [f"spans: device idle {view.idle_pct:.3f}% = host-bound "
             f"{view.host_bound_idle_pct:.3f} + sync-wait "
             f"{view.sync_idle_pct:.3f} + outside "
             f"{view.outside_idle_pct:.3f}", f"counters {counts}",
             "longest idle gaps " + ", ".join(
                 f"{n} {t * 1e3:.1f} ms" for n, t in view.idle_gaps)]
    for name in sorted(view.by_name):
        d = view.by_name[name]
        parts.append(f"{name} {int(d['calls'])} calls, host "
                     f"{d['host_ms']:.1f}/{d['self_ms']:.1f} ms, device "
                     f"{d['device_ms']:.1f}/{d['device_incl_ms']:.1f} ms, "
                     f"{int(d['launches'])} launches, "
                     f"{view.runtime_calls.get(name, 0)} runtime calls")
    return "; ".join(parts)


def traced_run(cell_name: str, seed: int, seconds: float, **kw):
    """`run.run_cell` traced, with the profiler it makes reducing the
    program's spans when it stops and the counters' change over the
    window: (the run's output, the view, the counters' change)."""
    import torch
    from . import run
    seen: Dict = {}
    base = torch.profiler.profile

    class Profile(base):
        def __enter__(self):
            seen["before"] = counters()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            seen["counts"] = delta(seen["before"], counters())
            seen["view"] = from_profile(self)
            return out

    torch.profiler.profile = Profile
    try:
        out = run.run_cell(cell_name, seed, seconds, True, **kw)
    finally:
        torch.profiler.profile = base
    return out, seen["view"], seen["counts"]


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    ap = argparse.ArgumentParser(
        description="One traced run of a cell and its program spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from . import run
    run._cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("benchmark.spans: needs a CUDA device", file=sys.stderr)
        return 1
    out, view, counts = traced_run(args.workload, args.seed, args.seconds)
    print(line(view, counts), file=sys.stderr, flush=True)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
