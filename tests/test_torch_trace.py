"""The port's spans and counters (`lang2seg_tpu_torch/utils/trace.py`) on
the CPU, and the benchmark's reduction of them (`benchmark/spans.py`).

A tiny model under `torch.profiler` emits the `l2s.*` spans of each layer
inside the span of the layer above it: `eval_image` on the device-paste
and the host paste-back paths, `eval_split` staged and unstaged, and one
Trainer step. With no profiler a span opens no range at all. The counter
`eval.h2d_bytes` counts what `Evaluator.h2d_bytes` counted before it gave
way to the counter (the numbers below were read from that attribute on
these fixtures). The reduction is checked on synthetic host and device
events: the idle split, where a launch goes, and the launches a span;
and `benchmark/trace.py::summarize` still reads what it read before the
program had spans."""

import threading
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import spans as bspans
from benchmark import trace as btrace
from lang2seg_tpu_torch.config import Config
from lang2seg_tpu_torch.data.fixtures import mini_refer_split
from lang2seg_tpu_torch.data.loader import GtBatchLoader
from lang2seg_tpu_torch.data.synthetic import (FixedBatchLoader,
                                              synthetic_batch, to_wire)
from lang2seg_tpu_torch.engine.evaluator import Evaluator
from lang2seg_tpu_torch.engine.trainer import Trainer
from lang2seg_tpu_torch.models.network import build_model
from lang2seg_tpu_torch.utils import trace
from lang2seg_tpu_torch.utils.metrics import SegEvalAccumulator

SIZES = ((100, 120), (120, 100), (150, 200), (100, 120), (120, 160))


def tiny_cfg() -> Config:
    """tests/test_network.py::tiny_config with the `response` variant's
    conditioning, in the port's Config; paste buffers of 160 x 160 (the
    150 x 200 image goes to the host)."""
    cfg = Config()
    cfg.data.canvas_h, cfg.data.canvas_w = 128, 192
    cfg.data.max_orig_h, cfg.data.max_orig_w = 160, 160
    m = cfg.model
    m.backbone, m.vocab_size, m.compute_dtype = "resnet26", 100, "float32"
    m.normalize_response, m.num_filters = True, 7
    m.response_gate, m.use_response_loss = "sigmoid", True
    t = cfg.train
    t.grad_clip_norm, t.learning_rate, t.roi_batch_size = 10.0, 1e-5, 32
    t.rpn_pre_nms_top_n, t.rpn_post_nms_top_n = 512, 128
    cfg.test.rpn_pre_nms_top_n, cfg.test.rpn_post_nms_top_n = 256, 32
    return cfg


@pytest.fixture(scope="module")
def setup():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = tiny_cfg()
    model = build_model(cfg, device="cpu", seed=0)
    info, labels, read = mini_refer_split(SIZES, (1,) * len(SIZES),
                                          ("val",) * len(SIZES), seed=3)
    batches = list(GtBatchLoader(info, labels, cfg, seed=3, read_image=read)
                   .iter_test_batches("val", buckets=(4,)))
    yield cfg, model, batches
    torch.set_num_threads(n)


def _profile(fn, all_threads=False):
    """The host events of `fn()` run under the profiler."""
    kw = {}
    if all_threads:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU], **kw) as prof:
        fn()
    return btrace._events(prof)[0]


def _nesting(host):
    """{span name: {(parent span name or None, same thread as the first
    span's)}} of the `l2s.` spans among `host`."""
    spans = [bspans._Span(e.name, e.start, e.end, e.tid) for e in host
             if e.name.startswith("l2s.") and e.end > e.start]
    assert spans
    bspans._Threads(spans)          # sets each span's parent
    first = min(spans, key=lambda s: s.start).tid
    out = {}
    for s in spans:
        out.setdefault(s.name, set()).add(
            (s.parent.name if s.parent else None, s.tid == first))
    return out


SERVE = {
    "l2s.request": None, "l2s.stage": "l2s.request",
    "l2s.stack": "l2s.stage", "l2s.upload": "l2s.stage",
    "l2s.dispatch": "l2s.request", "l2s.backbone": "l2s.dispatch",
    "l2s.condition": "l2s.dispatch", "l2s.gate": "l2s.condition",
    "l2s.rpn": "l2s.dispatch", "l2s.proposals": "l2s.dispatch",
    "l2s.nms": "l2s.proposals", "l2s.heads": "l2s.dispatch",
    "l2s.select": "l2s.dispatch", "l2s.mask": "l2s.dispatch",
    "l2s.paste": "l2s.dispatch", "l2s.sync.readback": "l2s.request",
    "l2s.accumulate": "l2s.request"}


def test_eval_image_spans(setup):
    """The device-paste request: every layer's span inside its parent on
    the calling thread; the ROI tail runs for the box and the mask
    branch."""
    cfg, model, batches = setup
    ev = Evaluator(model, cfg, device="cpu")
    nest = _nesting(_profile(lambda: ev.eval_image(
        batches[0], SegEvalAccumulator(), batches[0]["sent_valid"])))
    want = {k: {(v, True)} for k, v in SERVE.items()}
    want["l2s.roi_tail"] = {("l2s.dispatch", True), ("l2s.mask", True)}
    assert nest == want


def test_eval_image_host_path_spans(setup):
    """The host paste-back: the dispatch holds its uploads, the forward's
    layers, the selection and the mask branch; the readback and the
    paste-back follow."""
    cfg, model, batches = setup
    ev = Evaluator(model, cfg, device="cpu", device_paste=False)
    nest = _nesting(_profile(lambda: ev.eval_image(
        batches[0], SegEvalAccumulator(), batches[0]["sent_valid"])))
    want = {k: {(v, True)} for k, v in SERVE.items()
            if k not in ("l2s.stage", "l2s.stack", "l2s.paste")}
    want["l2s.upload"] = {("l2s.dispatch", True)}
    want["l2s.roi_tail"] = {("l2s.dispatch", True), ("l2s.mask", True)}
    assert nest == want


@pytest.mark.parametrize("staged", [False, True])
def test_eval_split_spans(setup, staged):
    """`eval_split` at two images a dispatch: the chunks' stacking and
    uploads inside the split on the calling thread, or, staged, on the
    pool's worker thread (followed with `profile_all_threads`) while the
    calling thread waits on it in `l2s.wait.staged`."""
    cfg, model, batches = setup
    ev = Evaluator(model, cfg, device="cpu")
    nest = _nesting(_profile(lambda: ev.eval_split(
        batches, images_per_dispatch=2, stage_uploads=staged),
        all_threads=staged))
    assert nest["l2s.eval_split"] == {(None, True)}
    for name in ("l2s.dispatch", "l2s.sync.readback", "l2s.accumulate"):
        assert nest[name] == {("l2s.eval_split", True)}, name
    assert ("l2s.dispatch", True) in nest["l2s.backbone"]
    assert ("l2s.proposals", True) in nest["l2s.nms"]
    if staged:
        assert nest["l2s.wait.staged"] == {("l2s.eval_split", True)}
        # the worker stages every chunk but the host-path image's
        assert nest["l2s.stage"] == {(None, False)}
        assert nest["l2s.stack"] == {("l2s.stage", False)}
        assert ("l2s.stage", False) in nest["l2s.upload"]
    else:
        assert "l2s.wait.staged" not in nest
        assert nest["l2s.stage"] == {("l2s.eval_split", True)}
        assert nest["l2s.stack"] == {("l2s.stage", True)}


def test_trainer_step_spans():
    """One Trainer step: the step inside the call, its batch wait, upload,
    forward (with the model's layers), backward and optimizer inside the
    step, the loss read at the end, the loader on the Prefetcher's
    thread."""
    cfg = tiny_cfg()
    cfg.train.display = 1
    batches = [to_wire(cfg, synthetic_batch(cfg, 2, 4, seed=10 + s))
               for s in range(2)]
    tr = Trainer(cfg, FixedBatchLoader(batches), device="cpu")
    nest = _nesting(_profile(lambda: tr.train(max_iters=1),
                             all_threads=True))
    assert nest["l2s.train"] == {(None, True)}
    assert nest["l2s.step"] == {("l2s.train", True)}
    for name in ("l2s.wait.batch", "l2s.upload", "l2s.forward",
                 "l2s.backward", "l2s.optimizer", "l2s.sync.losses"):
        assert nest[name] == {("l2s.step", True)}, name
    for name in ("l2s.backbone", "l2s.condition", "l2s.rpn", "l2s.targets",
                 "l2s.roi_tail", "l2s.heads", "l2s.mask"):
        assert nest[name] == {("l2s.forward", True)}, name
    assert nest["l2s.losses"] == {("l2s.forward", True)}
    assert nest["l2s.proposals"] == {("l2s.targets", True)}
    assert nest["l2s.nms"] == {("l2s.proposals", True)}
    # the gate's forward in the conditioning, its backward in the backward
    # (the CPU's autograd runs on the calling thread)
    assert nest["l2s.gate"] == {("l2s.condition", True),
                                ("l2s.backward", True)}
    assert (None, False) in nest["l2s.loader"]


def test_no_profiler_opens_no_range(setup, monkeypatch):
    """With no profiler a span reaches neither the dispatcher nor a
    RecordFunction: a request and a decorated function run with every
    range opener raising, and a name's null context is shared."""
    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "_open", refuse)
    cfg, model, batches = setup
    Evaluator(model, cfg, device="cpu").eval_image(
        batches[0], SegEvalAccumulator(), batches[0]["sent_valid"])
    with trace.span("l2s.x"):
        pass
    assert trace.span("l2s.x") is trace.span("l2s.x")
    assert trace.span("l2s.y")(lambda v: v + 1)(1) == 2


def test_span_without_profiler_costs_under_a_microsecond():
    """A `with span(...)` block with no profiler, less the empty loop:
    the best of ten rounds of 20,000 (0.1-0.2 us on this suite's hosts,
    0.4-0.5 us on the card machine's)."""
    n, best = 20_000, float("inf")
    for _ in range(10):
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("l2s.cost"):
                pass
        t1 = time.perf_counter()
        for _ in range(n):
            pass
        best = min(best, (t1 - t0 - (time.perf_counter() - t1)) / n)
    assert best < 1e-6


# bytes `Evaluator.h2d_bytes` counted on these fixtures before the
# counter took its place, and the images dispatched
H2D = {"image": (80216, 1), "split1": (368148, 5), "split2": (394772, 5),
       "split2_unstaged": (394772, 5), "host": (73908, 1)}


@pytest.mark.parametrize("mode", sorted(H2D))
def test_h2d_bytes_counter(setup, mode):
    cfg, model, batches = setup
    ev = Evaluator(model, cfg, device="cpu", device_paste=mode != "host")
    before = trace.counters()
    if mode in ("image", "host"):
        ev.eval_image(batches[0], SegEvalAccumulator(),
                      batches[0]["sent_valid"])
    else:
        ev.eval_split(batches, images_per_dispatch=1 if mode == "split1"
                      else 2, stage_uploads=mode == "split2")
    after = trace.counters()
    assert (after["eval.h2d_bytes"] - before.get("eval.h2d_bytes", 0),
            after["eval.images"] - before.get("eval.images", 0)) == H2D[mode]
    assert not hasattr(ev, "h2d_bytes")


# ---- benchmark/spans.py on synthetic events (ns) ----

PROGRAM, WORKER, AUTOGRAD = 1, 2, 3


def _ev(name, start, end, tid=PROGRAM, corr=0, linked=0, annotation=False):
    return btrace.Ev(name, start, end, tid, corr, linked, annotation)


def _scene(with_spans=True):
    """A 1000 ns window. The program thread: a request [100, 900) holding
    a dispatch [150, 500) that holds the ROI tail [200, 300), then a
    readback [600, 800); a worker's stage [120, 180); a thread with no
    span (the autograd engine's). Six launches (corr 1-6) and one op
    range of the benchmark's around the first."""
    host = [_ev("bench.window", 0, 1000),
            _ev("bench.op.roi_crop_fwd", 205, 290),
            _ev("cudaLaunchKernel", 210, 215, corr=1),
            _ev("cudaLaunchKernel", 160, 165, corr=2),
            _ev("cudaLaunchKernel", 250, 255, AUTOGRAD, corr=3),
            _ev("cudaMemcpyAsync", 130, 135, WORKER, corr=4),
            _ev("cudaLaunchKernel", 50, 55, corr=5),
            _ev("cudaLaunchKernel", 920, 925, AUTOGRAD, corr=6),
            _ev("aten::add", 905, 928, AUTOGRAD)]
    if with_spans:
        host += [_ev("l2s.request", 100, 900),
                 _ev("l2s.dispatch", 150, 500),
                 _ev("l2s.roi_tail", 200, 300),
                 _ev("l2s.sync.readback", 600, 800),
                 _ev("l2s.stage", 120, 180, WORKER)]
    dev = [_ev("k1", 300, 400, 7, corr=1), _ev("k2", 400, 450, 7, corr=2),
           _ev("k3", 450, 600, 7, corr=3), _ev("Memcpy", 200, 300, 8, corr=4),
           _ev("k5", 60, 90, 7, corr=5), _ev("k6", 930, 950, 7, corr=6),
           _ev("l2s.request", 100, 900, 7, annotation=True)]
    return host, dev


def test_idle_split_sums_to_the_idle_share():
    """Idle [0, 60) [90, 200) [600, 930) [950, 1000): 55%; the readback's
    200 ns is a wait on the device, the request's other idle 200 ns
    host-bound, 150 ns outside every span."""
    v = bspans.reduce(*_scene())
    assert v.idle_pct == pytest.approx(55.0)
    assert (v.host_bound_idle_pct, v.sync_idle_pct,
            v.outside_idle_pct) == pytest.approx((20.0, 20.0, 15.0))
    assert v.host_bound_idle_pct + v.sync_idle_pct + v.outside_idle_pct \
        == pytest.approx(v.idle_pct)
    assert v.has_spans and not bspans.reduce(*_scene(False)).has_spans
    assert v.idle_gaps == [["l2s.sync.readback", pytest.approx(330e-9)],
                           ["(outside)", pytest.approx(110e-9)],
                           ["(outside)", pytest.approx(60e-9)],
                           ["(outside)", pytest.approx(50e-9)]]


def test_launches_go_to_the_innermost_span():
    """A launch goes to the innermost span open at its call on its thread
    (the ROI tail, not the dispatch around it; the worker's stage), else
    on the program thread (the autograd thread's launch at 250); a launch
    outside every span goes nowhere."""
    v = bspans.reduce(*_scene())
    tail, disp, req = (v.by_name[n] for n in ("l2s.roi_tail", "l2s.dispatch",
                                              "l2s.request"))
    assert (tail["launches"], tail["device_ms"]) == (2, pytest.approx(250e-6))
    assert (disp["launches"], disp["device_ms"]) == (1, pytest.approx(50e-6))
    assert disp["device_incl_ms"] == pytest.approx(300e-6)
    assert req["device_incl_ms"] == pytest.approx(300e-6)
    assert (req["launches"], req["device_ms"]) == (0, 0.0)
    assert v.by_name["l2s.stage"]["device_ms"] == pytest.approx(100e-6)
    assert req["self_ms"] == pytest.approx(250e-6)
    assert disp["self_ms"] == pytest.approx(250e-6)
    assert sum(d["launches"] for d in v.by_name.values()) == 4


def test_runtime_calls_are_counted_per_span():
    """Runtime calls on any thread that start inside a span's intervals:
    four inside the request (the worker's copy and the autograd thread's
    launch included), the calls at 50 and 920 outside it."""
    v = bspans.reduce(*_scene())
    assert v.runtime_calls["l2s.request"] == 4
    assert v.runtime_calls["l2s.dispatch"] == 3
    assert v.runtime_calls["l2s.roi_tail"] == 2
    assert v.runtime_calls["l2s.sync.readback"] == 0
    assert v.calls("l2s.request") == 1 and v.calls("l2s.nothing") == 0


class _Kineto:
    """What `trace._events` reads of a profiler event."""

    def __init__(self, e, device):
        self.e, self.device = e, device

    def name(self):
        return self.e.name

    def start_ns(self):
        return self.e.start

    def duration_ns(self):
        return self.e.end - self.e.start

    def start_thread_id(self):
        return self.e.tid

    def correlation_id(self):
        return self.e.corr

    def linked_correlation_id(self):
        return self.e.linked

    def device_type(self):
        return self.device

    def activity_type(self):
        if self.device == DeviceType.CPU:
            return "cpu_op"
        return "gpu_user_annotation" if self.e.annotation else "kernel"


def _prof(host, dev):
    events = [_Kineto(e, DeviceType.CPU) for e in host] + \
        [_Kineto(e, DeviceType.CUDA) for e in dev]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


@pytest.mark.parametrize("with_spans", [False, True])
def test_summarize_reads_what_it_read(with_spans):
    """`summarize` on the same events, with and without the program's
    spans: the same busy and window time, op time and launches, device
    ops and idle gaps; only the names of gaps that a span now covers
    change (the innermost host range open at their start)."""
    s = btrace.summarize(_prof(*_scene(with_spans)))
    assert (s.window_s, s.busy_s) == pytest.approx((1e-6, 450e-9))
    assert s.op_device_s == {"roi_crop_fwd": pytest.approx(100e-9)}
    assert s.op_launches == {"roi_crop_fwd": 1}
    assert s.device_ops == [["k3", pytest.approx(150e-9)],
                            ["k1", pytest.approx(100e-9)],
                            ["Memcpy", pytest.approx(100e-9)],
                            ["k2", pytest.approx(50e-9)],
                            ["k5", pytest.approx(30e-9)],
                            ["k6", pytest.approx(20e-9)]]
    assert [g[0] for g in s.idle_gaps] == [
        "l2s.sync.readback" if with_spans else "(no host range)"] + \
        ["(no host range)"] * 3
    assert [g[1] for g in s.idle_gaps] == pytest.approx(
        [330e-9, 110e-9, 60e-9, 50e-9])
    v = bspans.from_profile(_prof(*_scene(with_spans)))
    assert v.idle_pct == pytest.approx(100 * (1 - s.busy_s / s.window_s))


def test_counters_reader_and_delta():
    assert bspans.delta({"a": 2}, {"a": 5, "b": 1}) == {"a": 3, "b": 1}
    trace.count("test.counter", 3)
    assert bspans.counters()["test.counter"] >= 3


def _recorded_counts(case):
    """(totals and keyed counts of `test.rec` before, after) around one
    case of a recording, and the record."""
    def snap():
        return (trace.counters().get("test.rec", 0),
                trace.by_key("test.rec"))
    before = snap()
    with trace.recording() as record:
        trace.count("test.rec", 2, key=("a", 1))
        trace.count("test.rec", key=("b", 2))
        if case == "other_thread":
            worker = threading.Thread(
                target=lambda: trace.count("test.rec", 5, key=("c", 3)))
            worker.start()
            worker.join()
    inside = snap()
    if case == "add":
        trace.add(record, times=3)
    return before, inside, snap(), record


@pytest.mark.parametrize("case", ["recorded", "add", "other_thread"])
def test_recording_keeps_counts_out_of_the_totals(case):
    """Counts made inside `recording()` on its thread go to its record
    and not to the totals; `add(record, times=k)` adds k x the record to
    the totals and to each key's count; a count made on another thread
    meanwhile goes to the totals."""
    before, inside, after, record = _recorded_counts(case)
    assert record == {("test.rec", ("a", 1)): 2, ("test.rec", ("b", 2)): 1}
    total, keyed = before

    def plus(*added):
        out = dict(keyed)
        for key, n in added:
            out[key] = out.get(key, 0) + n
        return out
    if case == "recorded":
        assert inside == after == before
    elif case == "add":
        assert inside == before
        assert after == (total + 9, plus((("a", 1), 6), (("b", 2), 3)))
    else:
        assert inside == after == (total + 5, plus((("c", 3), 5)))


def test_traced_run_reduces_the_programs_spans(setup):
    """`benchmark.spans.traced_run`: one traced run of the serving cell at
    its tiny size on the CPU gives `benchmark.run`'s result, a view with
    each request's layers inside it, the counters' change over the
    window alone, an idle split that adds up, and the profiler put
    back."""
    from benchmark.tests.tiny import tiny_cell
    cfg, traffic = tiny_cell("response.serve.e16")
    base = torch.profiler.profile
    out, view, counts = bspans.traced_run(
        "response.serve.e16", 2 ** 31 + 12345, 0.2, device="cpu",
        cfg_file=cfg, traffic=traffic)
    assert torch.profiler.profile is base
    assert set(out["result"]["metrics"]) == {"device_idle_pct.serve",
                                             "mfu.serve"}
    n = view.calls("l2s.request")
    assert n >= 1 and counts["eval.images"] == n
    assert counts["eval.h2d_bytes"] > 0
    for name in ("l2s.backbone", "l2s.roi_tail", "l2s.sync.readback"):
        assert view.calls(name) >= n
    assert view.host_bound_idle_pct + view.sync_idle_pct + \
        view.outside_idle_pct == pytest.approx(view.idle_pct)
    assert f"{view.runtime_calls.get('l2s.request', 0)} runtime calls" in \
        bspans.line(view, counts).split("l2s.request ")[1].split(";")[0]
