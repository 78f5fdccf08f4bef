"""The language half of the conditioning replayed as a CUDA graph
(`models/network.py::Lang2Seg._filters`, over `device.GraphedPasses`):
which calls take it, what a replay must find unchanged, how a capture's
counts reach the counters, and on the card that a replay gives the eager
pass's filters and gate output bit for bit and fresh tensors, follows
in-place weight updates, runs eager past the cap and leaves the gate's
launch outside the graph. The `cuda` cases skip without a card; the file
imports nothing of JAX:

    python -m pytest tests/test_torch_graphed_condition.py -m cuda --noconftest -q
"""

import contextlib

import pytest
import torch

from lang2seg_tpu_torch.config import flagship_config
from lang2seg_tpu_torch.device import GraphedPasses
from lang2seg_tpu_torch.models import network
from lang2seg_tpu_torch.models.network import build_model
from lang2seg_tpu_torch.tools.profile_bn_act import same_bits
from lang2seg_tpu_torch.utils import trace

COUNTERS = ("condition.graph_captures", "condition.graph_replays",
            "condition.graph_eager", "gate.launches")
CUDA = pytest.param("cuda", marks=pytest.mark.cuda)
T = 10      # the flagship's max_len


def _counts():
    c = trace.counters()
    return {k: c.get(k, 0) for k in COUNTERS}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph runs only on the card")
    return torch.device(name)


def _model(dev):
    """The flagship conditioning (bi-LSTM 2 x 512, 7 filters, sigmoid gate,
    C = 1024) on a resnet26 backbone, in eval mode."""
    cfg = flagship_config()
    cfg.model.backbone = "resnet26"
    if dev.type == "cpu":
        cfg.model.compute_dtype = "float32"
    return build_model(cfg, device=dev, seed=0)


def _labels(dev, e, seed=1):
    """(E, T) expressions of 0 to T words (0 = PAD after the last word)."""
    g = torch.Generator().manual_seed(seed)
    labels = torch.randint(1, 2000, (e, T), generator=g, dtype=torch.int32)
    lengths = torch.randint(0, T + 1, (e,), generator=g)
    labels[torch.arange(T)[None, :] >= lengths[:, None]] = 0
    return labels.to(dev)


def _maps(dev, n, dtype, seed=2, h=40, w=64):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, h, w, 1024), generator=g).to(dev, dtype)


@pytest.fixture(scope="module")
def cpu_model():
    return _model(torch.device("cpu"))


def test_cpu_labels_run_eager(cpu_model):
    """Under no_grad CPU labels take the eager pass: no graph, the four
    counters unchanged (the gate's plain version runs on the CPU); the
    filters are the filter generator's on the encoder's hidden state."""
    model = cpu_model
    labels, conv = _labels("cpu", 6), _maps("cpu", 2, torch.float32, h=4, w=6)
    before = _counts()
    with torch.no_grad():
        filt, rfilt = model._filters(labels)
        gated, response = model._condition(conv, labels, exprs_per_map=3)
        hidden = model.rnn_encoder(labels)[1]
        want = model.filter_gen.filters(hidden)
        want_gated, want_response = model.filter_gen(conv, hidden, 3)
    assert _delta(before) == dict.fromkeys(before, 0)
    assert model not in network._LANGUAGE_GRAPHS
    assert filt.shape == (6, 1024, 7) and rfilt.shape == (6, 7)
    assert torch.equal(filt, want[0]) and torch.equal(rfilt, want[1])
    assert torch.equal(gated, want_gated)
    assert torch.equal(response, want_response)


class _OnCard(torch.Tensor):
    """CPU labels that say they are on the card, so that `_filters` weighs
    the other conditions (its `GraphedPasses.run` is replaced)."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("case, replays", [
    ("inference", True), ("on_cpu", False), ("grad", False),
    ("train_mode", False), ("capturing", False)])
def test_which_calls_replay(cpu_model, monkeypatch, case, replays):
    """Only labels on the card, with no gradient recorded, the encoder in
    eval mode and no capture under way take the graph; every other call
    runs the eager pass, with no option deciding."""
    model = cpu_model
    calls = []

    def run(self, fn, inputs, reads, cap):
        calls.append((fn, inputs, reads, cap))
        return "replayed"
    monkeypatch.setattr(GraphedPasses, "run", run)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: case == "capturing")
    labels = _labels("cpu", 4)
    if case != "on_cpu":
        labels = labels.as_subclass(_OnCard)
    grad = torch.enable_grad() if case == "grad" else torch.no_grad()
    try:
        model.train(case == "train_mode")
        with grad:
            got = model._filters(labels, torch.Generator().manual_seed(0))
    finally:
        model.eval()
        network._LANGUAGE_GRAPHS.pop(model, None)
    if replays:
        assert got == "replayed" and len(calls) == 1
        fn, inputs, reads, cap = calls[0]
        assert fn == model._language and inputs[0] is labels
        assert cap == network.CONDITION_GRAPH_KEYS
        assert len(reads) == 1 + 2 + 8 + 7 * 2 + 2
    else:
        assert calls == [] and len(got) == 2
        assert got[0].shape == (4, 1024, 7)


@pytest.mark.parametrize("device", ["cpu", CUDA])
@pytest.mark.parametrize("mode", ["grad", "train_mode"])
def test_training_calls_stay_eager(device, mode):
    """A call that records a gradient (eval-mode validation with grad on,
    every train step) or a train-mode encoder (word dropout drawn from a
    CPU generator) runs eager and is differentiable: the LSTM and the
    filter heads get gradients; no graph."""
    dev = _device(device)
    model = _model(dev)
    model.train(mode == "train_mode")
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    labels, conv = _labels(dev, 4), _maps(dev, 1, dtype, h=8, w=12)
    before = _counts()
    gated, response = model._condition(conv, labels,
                                       torch.Generator().manual_seed(0),
                                       exprs_per_map=4)
    assert response.requires_grad
    response.float().square().mean().backward()
    for p in (model.rnn_encoder.rnn.weight_hh_l0_reverse,
              model.dynamic_fc_3.weight, model.response_fc.bias):
        assert p.grad is not None and bool(p.grad.abs().sum() > 0)
    assert _delta(before) == {"condition.graph_captures": 0,
                              "condition.graph_replays": 0,
                              "condition.graph_eager": 0,
                              "gate.launches": 1 if dev.type == "cuda" else 0}
    assert model not in network._LANGUAGE_GRAPHS


def test_reads_change_on_rebind_not_in_place(cpu_model):
    """What a replay must find unchanged: the address of each of the
    encoder's and filter heads' 27 tensors. An in-place update and
    `load_state_dict`'s copy keep them; a re-bind to other storage
    (`load_state_dict(assign=True)`, `.to()` of another dtype) changes
    them."""
    model = cpu_model
    g = GraphedPasses([model.rnn_encoder, *model.filter_gen.children()],
                      "condition")
    # embedding, mlp.0 (weight, bias), the LSTM's 2 x 4, 7 filter heads and
    # the response head (weight, bias)
    assert len(g.dicts) == 1 + 2 + 8 + 7 * 2 + 2
    r0 = g.addresses()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.rnn_encoder.rnn.weight_hh_l0.mul_(2)
        model.dynamic_fc_6.bias.add_(1)
    model.load_state_dict(sd)
    assert g.addresses() == r0
    try:
        model.load_state_dict(
            {k: v.clone() for k, v in model.state_dict().items()},
            assign=True)
        r1 = g.addresses()
        assert r1 != r0
        model.rnn_encoder.to(torch.float64)
        assert g.addresses() != r1
    finally:
        model.rnn_encoder.to(torch.float32)
        model.load_state_dict(sd)


class _NoGraph:
    """Stands in for a CUDA graph, a stream and their contexts on the CPU:
    the "captured" callable simply runs, and a replay does nothing."""

    def register_generator_state(self, g):
        pass

    def wait_stream(self, other):
        pass

    def replay(self):
        pass


def test_capture_records_its_pass_and_a_replay_adds_it(cpu_model,
                                                       monkeypatch):
    """`GraphedPasses.run` with the CUDA pieces stood in for: the first
    call at a key warms (counted as it runs), captures (into the record,
    not the counters) and replays (adding the record); the next call at
    that key replays; a fresh copy of the output each time; past the cap
    the pass runs eager; other reads drop the graphs and capture again."""
    nothing = contextlib.nullcontext
    for name, value in (("CUDAGraph", _NoGraph), ("Stream", _NoGraph),
                        ("current_stream", _NoGraph),
                        ("stream", lambda s: nothing()),
                        ("graph", lambda *a, **k: nothing()),
                        ("device", lambda d: nothing()),
                        ("graph_pool_handle", lambda: (0, 1)),
                        ("synchronize", lambda d=None: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    model = cpu_model
    name = "condition_test.passes"

    def language(labels):
        trace.count(name)
        return model._language(labels)

    def passes():
        return trace.counters().get(name, 0)
    g = GraphedPasses([model.rnn_encoder, *model.filter_gen.children()],
                      "condition")
    labels = _labels("cpu", 4)
    with torch.no_grad():
        want = model._language(labels)
        before, p0 = _counts(), passes()
        first = g.run(language, (labels,), g.addresses(), 2)
        assert _delta(before)["condition.graph_captures"] == 1
        assert passes() == p0 + 2              # the warm pass and the replay
        (hit,) = g.by_key.values()
        assert hit.record == {(name, None): 1}
        assert isinstance(hit.graph, _NoGraph)
        second = g.run(language, (labels,), g.addresses(), 2)
        assert passes() == p0 + 3
        for got in (first, second):
            assert all(same_bits(a, b) for a, b in zip(got, want))
            assert all(a.data_ptr() != b.data_ptr()
                       for a, b in zip(got, hit.static_out))
        assert first[0].data_ptr() != second[0].data_ptr()
        other = _labels("cpu", 8)
        eager = g.run(language, (other,), g.addresses(), 1)
        assert all(same_bits(a, b)
                   for a, b in zip(eager, model._language(other)))
        assert _delta(before) == {"condition.graph_captures": 1,
                                  "condition.graph_replays": 2,
                                  "condition.graph_eager": 1,
                                  "gate.launches": 0}
        g.run(language, (labels,), ("other reads",), 2)
        assert _delta(before)["condition.graph_captures"] == 2
        assert g.by_key.keys() == {((labels.shape, labels.dtype,
                                     labels.device),)}


# ---- on the card ----

@pytest.fixture
def dev():
    return _device("cuda")


def _eager(model, conv, labels, per_map):
    filt, rfilt = model._language(labels)
    return (filt, rfilt) + model.filter_gen.gate_map(conv, filt, rfilt,
                                                     per_map)


def _graphed(model, conv, labels, per_map):
    filt, rfilt = model._filters(labels)
    return (filt, rfilt) + model.filter_gen.gate_map(conv, filt, rfilt,
                                                     per_map)


@pytest.mark.cuda
@pytest.mark.parametrize("maps, per_map", [(1, 16), (4, 4), (2, 8), (4, 8),
                                           (4, 16)])
def test_replay_equals_eager(dev, maps, per_map):
    """At serving's E = 16 on one stride-0 map and at eval's dispatches
    (maps images of per_map expressions each): the first call captures
    and the next replays; the filters, the response filters, the gated map
    and the response are the eager pass's bits, and `_condition` gives
    them too. One gate launch a call."""
    model = _model(dev)
    e = maps * per_map
    labels = _labels(dev, e)
    conv = _maps(dev, maps, torch.bfloat16)
    with torch.no_grad():
        want = _eager(model, conv, labels, per_map)
        before = _counts()
        first = _graphed(model, conv, labels, per_map)
        second = _graphed(model, conv, labels, per_map)
        third = model._condition(conv, labels, exprs_per_map=per_map)
    torch.cuda.synchronize()
    for got in (first, second):
        assert all(same_bits(a, b) for a, b in zip(got, want))
    assert same_bits(third[0], want[2]) and same_bits(third[1], want[3])
    assert want[0].shape == (e, 1024, 7) and bool(want[3].abs().sum() > 0)
    assert _delta(before) == {"condition.graph_captures": 1,
                              "condition.graph_replays": 3,
                              "condition.graph_eager": 0,
                              "gate.launches": 3}


@pytest.mark.cuda
def test_first_output_survives_a_second_call(dev):
    """A call's filters are its own tensors: a later call on other labels
    of the same shape does not overwrite them."""
    model = _model(dev)
    l1, l2 = _labels(dev, 16, seed=1), _labels(dev, 16, seed=2)
    with torch.no_grad():
        want1, want2 = model._language(l1), model._language(l2)
        got1 = model._filters(l1)
        got2 = model._filters(l2)
        got3 = model._filters(l1)
    torch.cuda.synchronize()
    for got, want in ((got1, want1), (got2, want2), (got3, want1)):
        assert all(same_bits(a, b) for a, b in zip(got, want))
    assert not same_bits(want1[0], want2[0])
    assert len({got1[0].data_ptr(), got2[0].data_ptr(),
                got3[0].data_ptr()}) == 3


@pytest.mark.cuda
def test_in_place_weight_change_seen_without_capture(dev):
    """An in-place update (an SGD step, `load_state_dict`'s copy) of the
    LSTM, a filter head and the embedding is read by the next replay: no
    capture."""
    model = _model(dev)
    labels = _labels(dev, 16)
    with torch.no_grad():
        old = model._filters(labels)
        model.rnn_encoder.rnn.weight_hh_l0_reverse.mul_(1.5)
        model.dynamic_fc_2.weight.mul_(0.5)
        model.load_state_dict({
            k: v * 0.75 if k == "rnn_encoder.embedding.weight" else v
            for k, v in model.state_dict().items()})
        before = _counts()
        got = model._filters(labels)
        want = model._language(labels)
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(got, want))
    assert not same_bits(got[0], old[0]) and not same_bits(got[1], old[1])
    delta = _delta(before)
    assert (delta["condition.graph_captures"],
            delta["condition.graph_replays"]) == (0, 1)


@pytest.mark.cuda
def test_load_state_dict_assign_captures_again(dev):
    """Fresh tensors bound by `load_state_dict(assign=True)`: the next call
    captures again and matches eager on the new weights."""
    model = _model(dev)
    labels = _labels(dev, 16)
    with torch.no_grad():
        old = model._filters(labels)
        fresh = {k: (v * 1.25 if k.startswith("dynamic_fc") else v).clone()
                 for k, v in model.state_dict().items()}
        model.load_state_dict(fresh, assign=True)
        before = _counts()
        got = model._filters(labels)
        want = model._language(labels)
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(got, want))
    assert not same_bits(got[0], old[0])
    delta = _delta(before)
    assert (delta["condition.graph_captures"],
            delta["condition.graph_replays"]) == (1, 1)


@pytest.mark.cuda
def test_past_the_cap_runs_eager(dev, monkeypatch):
    """Past `CONDITION_GRAPH_KEYS` label shapes a call runs eager and
    counts `condition.graph_eager`; the captured shape still replays."""
    monkeypatch.setattr(network, "CONDITION_GRAPH_KEYS", 1)
    model = _model(dev)
    l1, l2 = _labels(dev, 16), _labels(dev, 32)
    before = _counts()
    with torch.no_grad():
        got1 = model._filters(l1)
        got2 = model._filters(l2)
        again = model._filters(l1)
        want1, want2 = model._language(l1), model._language(l2)
    torch.cuda.synchronize()
    for got, want in ((got1, want1), (got2, want2), (again, want1)):
        assert all(same_bits(a, b) for a, b in zip(got, want))
    delta = _delta(before)
    assert (delta["condition.graph_captures"],
            delta["condition.graph_replays"],
            delta["condition.graph_eager"]) == (1, 2, 1)


@pytest.mark.cuda
def test_gate_counts_one_launch_a_call_either_way(dev):
    """The gate runs outside the graph: a capturing call, a replay and an
    eager call with grad on each count one `gate.launches`; the captured
    pass has no hand kernel, so its record is empty."""
    model = _model(dev)
    labels = _labels(dev, 16)
    conv = _maps(dev, 1, torch.bfloat16)
    counts = []
    for grad in (False, False, True):
        before = _counts()
        with torch.set_grad_enabled(grad):
            model._condition(conv, labels, exprs_per_map=16)
        counts.append(_delta(before)["gate.launches"])
    assert counts == [1, 1, 1]
    (hit,) = network._LANGUAGE_GRAPHS[model].by_key.values()
    assert hit.record == {}
