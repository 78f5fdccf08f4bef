"""The ResNet-C4 head replayed as a CUDA graph (`models/resnet.py::
ResNetC4.head`): which calls take it, what a replay must find unchanged,
how a capture's counts reach the counters (`device.capture_graph`), and
on the card that a replay gives the eager pass's bits and a fresh
tensor, follows in-place weight updates, captures again after a re-bind
and runs eager past the cap. The `cuda` cases skip without a card; the
file imports nothing of JAX:

    python -m pytest tests/test_torch_graphed_head.py -m cuda --noconftest -q
"""

import collections
import contextlib

import pytest
import torch

from lang2seg_tpu_torch.device import capture_graph
from lang2seg_tpu_torch.models import resnet
from lang2seg_tpu_torch.models.resnet import ResNetC4
from lang2seg_tpu_torch.ops import bn_act_cuda
from lang2seg_tpu_torch.ops.bn_act_cuda import bn_act_plain
from lang2seg_tpu_torch.tools.profile_bn_act import same_bits, unfused
from lang2seg_tpu_torch.utils import trace

COUNTERS = ("backbone.graph_captures", "backbone.graph_replays",
            "backbone.graph_eager")
CUDA = pytest.param("cuda", marks=pytest.mark.cuda)


def _counts():
    c = trace.counters()
    return {k: c.get(k, 0) for k in COUNTERS + ("bn_act.launches",)}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph runs only on the card")
    return torch.device(name)


def _net(dev, dtype=torch.bfloat16, seed=0):
    """A resnet26 with random frozen statistics, channels_last weights."""
    torch.manual_seed(seed)
    net = ResNetC4("resnet26", dtype)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, resnet.FrozenBatchNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.2, 0.2)
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 2.0)
    return net.to(dev).to(memory_format=torch.channels_last)


def _images(dev, n, seed=1, h=128, w=192):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, h, w, 3), generator=g) * 60).to(dev)


def test_cpu_input_runs_eager():
    """Under no_grad a CPU input takes the eager pass: no graph, the three
    counters unchanged."""
    net, x = _net("cpu", torch.float32), _images("cpu", 2, h=64, w=96)
    before = _counts()
    with torch.no_grad():
        got = net.head(x)
        want = net._head(x)
    assert _delta(before) == dict.fromkeys(before, 0)
    assert net not in resnet._GRAPHS
    assert torch.equal(got, want) and got.shape == (2, 4, 6, 1024)


@pytest.mark.parametrize("device", ["cpu", CUDA])
def test_grad_enabled_call_stays_eager(device):
    """A call that records a gradient (every train step) runs eager and is
    differentiable: layer3's weights get a gradient; no graph, no replay."""
    dev = _device(device)
    net = _net(dev, torch.float32 if dev.type == "cpu" else torch.bfloat16)
    net.freeze(2)
    x = _images(dev, 1, h=64, w=96)
    before = _counts()
    out = net.head(x)
    assert out.requires_grad
    out.float().square().mean().backward()
    w = net.layer3[0].conv2.weight
    assert w.grad is not None and bool(w.grad.abs().sum() > 0)
    assert net.layer1[0].conv1.weight.grad is None
    delta = _delta(before)
    assert (delta["backbone.graph_captures"], delta["backbone.graph_replays"],
            delta["backbone.graph_eager"]) == (0, 0, 0)
    assert net not in resnet._GRAPHS


def test_reads_change_on_rebind_not_in_place():
    """What a replay must find unchanged (`_Graphs.reads_now`): an in-place
    update and `load_state_dict`'s copy keep it; a re-bind to other
    storage (`.to()` of a layout, `load_state_dict(assign=True)`), another
    BatchNorm pass and another compute dtype change it."""
    net = ResNetC4("resnet26", torch.float32)
    g = resnet._Graphs(net)
    # conv1 and bn1's four buffers, then a block a stage: 4 convolutions
    # and 4 BatchNorms
    assert len(g.dicts) == 1 + 4 + 3 * (4 + 4 * 4)
    r0 = g.reads_now(net)
    with torch.no_grad():
        net.layer3[0].conv2.weight.mul_(2)
        net.bn1.running_var.add_(1)
    net.load_state_dict({k: v.clone() for k, v in net.state_dict().items()})
    assert g.reads_now(net) == r0
    net.to(memory_format=torch.channels_last)   # conv1's 7 x 7 weight moves
    r1 = g.reads_now(net)
    assert r1 != r0
    net.load_state_dict({k: v.clone() for k, v in net.state_dict().items()},
                        assign=True)
    r2 = g.reads_now(net)
    assert r2 != r1
    with unfused():
        assert g.reads_now(net) != r2
    net.dtype = torch.bfloat16
    assert g.reads_now(net) != r2


class _NoGraph:
    """Stands in for a CUDA graph, a stream and their contexts on the CPU:
    the "captured" callable simply runs."""

    def register_generator_state(self, g):
        pass

    def wait_stream(self, other):
        pass


def _bn_pass(x, bn):
    """Two counted bn_act launches on x's shape: ReLU only, and with a
    residual."""
    return bn_act_cuda.bn_act_forward(bn_act_cuda.bn_act_forward(x, bn), bn,
                                      x)


def test_capture_records_its_pass_and_a_replay_adds_it(monkeypatch):
    """`device.capture_graph` (both graphs' capture): the warm pass counts
    as it runs, the captured pass goes to the record and not to the
    counters, and the record added once, as a replay adds it, raises
    `bn_act.launches` and its count by shape by that pass."""
    nothing = contextlib.nullcontext
    for name, value in (("CUDAGraph", _NoGraph), ("Stream", _NoGraph),
                        ("current_stream", _NoGraph),
                        ("stream", lambda s: nothing()),
                        ("graph", lambda *a, **k: nothing())):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(
        bn_act_cuda, "launch_forward", lambda x, bn, other=None, bn_d=None:
        bn_act_plain(x, bn, other))
    x = torch.randn((1, 12, 8, 8), generator=torch.Generator().manual_seed(
        0)).contiguous(memory_format=torch.channels_last)
    bn = resnet.FrozenBatchNorm(12)
    keys = [bn_act_cuda.shape_key(x, mode) for mode in (0, 1)]

    def snap():
        by = trace.by_key("bn_act.launches")
        return (trace.counters().get("bn_act.launches", 0),
                [by.get(k, 0) for k in keys])
    n0, by0 = snap()
    graph, out, record = capture_graph(lambda: _bn_pass(x, bn),
                                       warm=lambda: _bn_pass(x, bn))
    n1, by1 = snap()
    assert isinstance(graph, _NoGraph)
    assert torch.equal(out, bn_act_plain(bn_act_plain(x, bn), bn, x))
    assert record == {("bn_act.launches", k): 1 for k in keys}
    assert (n1, by1) == (n0 + 2, [b + 1 for b in by0])     # the warm pass
    trace.add(record)
    assert snap() == (n1 + 2, [b + 1 for b in by1])


# ---- on the card ----

@pytest.fixture
def dev():
    return _device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4])
def test_replay_equals_eager(dev, n):
    """The first call captures and the next replays; both give the eager
    pass's bits, shape, strides and dtype. The warm pass before the
    capture and each replay count one pass of bn_act launches, the capture
    none."""
    net, x = _net(dev), _images(dev, n)
    with torch.no_grad():
        c0 = _counts()
        want = net._head(x)
        per_pass = _delta(c0)["bn_act.launches"]
        before = _counts()
        first = net.head(x)
        second = net.head(x)
    torch.cuda.synchronize()
    for got in (first, second):
        assert same_bits(got, want)
        assert (got.shape, got.stride(), got.dtype) == \
            (want.shape, want.stride(), want.dtype)
    assert bool(want.abs().sum() > 0)
    assert _delta(before) == {"backbone.graph_captures": 1,
                              "backbone.graph_replays": 2,
                              "backbone.graph_eager": 0,
                              "bn_act.launches": 3 * per_pass}


@pytest.mark.cuda
def test_first_output_survives_a_second_call(dev):
    """A call's result is its own tensor: a later call on other data does
    not overwrite it."""
    net = _net(dev)
    x1, x2 = _images(dev, 1, seed=1), _images(dev, 1, seed=2)
    with torch.no_grad():
        want1, want2 = net._head(x1), net._head(x2)
        got1 = net.head(x1)
        got2 = net.head(x2)
        got3 = net.head(x1)
    torch.cuda.synchronize()
    assert same_bits(got1, want1) and same_bits(got2, want2)
    assert same_bits(got3, want1)
    assert not same_bits(want1, want2)
    assert got1.data_ptr() != got2.data_ptr() != got3.data_ptr()


@pytest.mark.cuda
def test_load_state_dict_assign_captures_again(dev):
    """Fresh tensors bound by `load_state_dict(assign=True)`: the next call
    captures again and matches eager on the new weights."""
    net, x = _net(dev), _images(dev, 2)
    with torch.no_grad():
        old = net.head(x)
        fresh = {k: (v * 1.25 if k.endswith("weight") else v).clone()
                 for k, v in net.state_dict().items()}
        net.load_state_dict(fresh, assign=True)
        before = _counts()
        got = net.head(x)
        want = net._head(x)
    torch.cuda.synchronize()
    assert same_bits(got, want) and not same_bits(got, old)
    delta = _delta(before)
    assert (delta["backbone.graph_captures"],
            delta["backbone.graph_replays"]) == (1, 1)


@pytest.mark.cuda
def test_in_place_weight_change_seen_without_capture(dev):
    """An in-place update (an SGD step, `load_state_dict`'s copy) is read
    by the next replay: no capture."""
    net, x = _net(dev), _images(dev, 1)
    with torch.no_grad():
        old = net.head(x)
        net.layer3[0].conv2.weight.mul_(1.5)
        net.load_state_dict({k: v * 0.75 if k == "bn1.weight" else v
                             for k, v in net.state_dict().items()})
        before = _counts()
        got = net.head(x)
        want = net._head(x)
    torch.cuda.synchronize()
    assert same_bits(got, want) and not same_bits(got, old)
    delta = _delta(before)
    assert (delta["backbone.graph_captures"],
            delta["backbone.graph_replays"]) == (0, 1)


@pytest.mark.cuda
def test_past_the_cap_runs_eager(dev, monkeypatch):
    """Past `GRAPH_KEYS` input keys a call runs eager and counts
    `backbone.graph_eager`; the captured key still replays."""
    monkeypatch.setattr(resnet, "GRAPH_KEYS", 1)
    net = _net(dev)
    x1, x2 = _images(dev, 1), _images(dev, 2)
    before = _counts()
    with torch.no_grad():
        got1 = net.head(x1)
        got2 = net.head(x2)
        again = net.head(x1)
        want1, want2 = net._head(x1), net._head(x2)
    torch.cuda.synchronize()
    assert same_bits(got1, want1) and same_bits(again, want1)
    assert same_bits(got2, want2)
    delta = _delta(before)
    assert (delta["backbone.graph_captures"], delta["backbone.graph_replays"],
            delta["backbone.graph_eager"]) == (1, 2, 1)


@pytest.mark.cuda
def test_swapped_batchnorm_pass_captures_again(dev):
    """Inside `profile_bn_act.unfused` the head captures the composition
    anew: its bits, and no bn_act launch counted; back outside, the
    kernels' pass again."""
    net, x = _net(dev), _images(dev, 1)
    with torch.no_grad():
        fused = net.head(x)
        with unfused():
            before = _counts()
            plain = net.head(x)
            delta = _delta(before)
            want = net._head(x)
        again = net.head(x)
    torch.cuda.synchronize()
    assert same_bits(plain, want) and same_bits(again, fused)
    assert (delta["backbone.graph_captures"], delta["bn_act.launches"]) == \
        (1, 0)


@pytest.mark.cuda
def test_bn_act_shapes_count_replays(dev):
    """A replay adds its pass's bn_act launches by shape, as the wrappers
    count them in an eager pass."""
    net, x = _net(dev), _images(dev, 1)
    def shapes():
        return collections.Counter(trace.by_key("bn_act.launches"))
    with torch.no_grad():
        s0 = shapes()
        net._head(x)
        per_pass = shapes() - s0
        net.head(x)
        s1 = shapes()
        net.head(x)
        replayed = shapes() - s1
    assert replayed == per_pass and sum(per_pass.values()) > 0
