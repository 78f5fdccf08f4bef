"""CUDA kernels of the PyTorch port against their plain versions, on the
card. These tests need an NVIDIA GPU with nvcc (the kernels have no
CPU mode) and skip without one; they import nothing of JAX, so they run
on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

`chip_smoke.py` runs the same comparisons at the flagship shapes."""

import collections
import copy
import os

import numpy as np
import pytest
import torch

from lang2seg_tpu_torch.ops import (fused_filter, nms_cuda, roi_crop_cuda,
                                    roi_pool_cuda)
from lang2seg_tpu_torch.ops.fused_filter import (
    fused_dynamic_filter_bwd_plain, fused_dynamic_filter_plain)
from lang2seg_tpu_torch.ops.nms import nms_padded
from lang2seg_tpu_torch.ops.roi_align import (roi_max_pool,
                                              roi_max_pool_argmax_plain,
                                              roi_max_pool_bwd_plain,
                                              roi_max_pool_plain)
from lang2seg_tpu_torch.tools.profile_bn_act import same_bits
from lang2seg_tpu_torch.tools.profile_gate import bf16_ulp_distance
from lang2seg_tpu_torch.tools.profile_nms import edge_cases
from lang2seg_tpu_torch.tools.profile_roi_pool import roi_pool_inputs
from lang2seg_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

# launch counters (`utils/trace.py`) read together
SERVED = ("nms.launches", "gate.launches")
TRAINED = SERVED + ("gate.bwd_launches",)
CROPS = ("roi_crop.launches", "roi_crop.bwd_launches")
BN_ACT = ("bn_act.launches", "bn_act.bwd_launches")


def _n(name):
    """The counter `name` so far."""
    return trace.counters().get(name, 0)


def _counts(names):
    """The counters `names` so far, by name."""
    return {name: _n(name) for name in names}


def _since(before, after=None):
    """Each counter's change from the counts `before` to `after` (by
    default now), in `before`'s order."""
    after = after or _counts(before)
    return tuple(after[name] - before[name] for name in before)


def _shapes(name):
    """The counts of `name` by shape so far."""
    return collections.Counter(trace.by_key(name))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _boxes(rng, e, n, lim=100.0):
    xy = rng.uniform(0, lim, (e, n, 2))
    wh = rng.uniform(5, lim / 2, (e, n, 2))
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                            .astype(np.float32))


# the small edge cases of chip_smoke.py phase 3, by name
EDGE = {c[0]: c[1:] for c in edge_cases() if c[1].shape[1] <= 500}
RANDOM = [(3, 700, 0.7, 128), (2, 64, 0.5, 64), (1, 1, 0.7, 4),
          (4, 2000, 0.99, 300)]


def _nms_case(case, dev):
    """(boxes, valid, thresh, max_out) on the card: a random draw for
    (e, n, thresh, max_out), or the edge case of that name."""
    if isinstance(case, str):
        b, v, thresh, max_out = EDGE[case]
        return (torch.from_numpy(b).to(dev), torch.from_numpy(v).to(dev),
                thresh, max_out)
    e, n, thresh, max_out = case
    rng = np.random.RandomState(n)
    boxes = _boxes(rng, e, n).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(e, n)) > 0.1).to(dev)
    return boxes, valid, thresh, max_out


@pytest.mark.parametrize("case", [pytest.param(c, id="-".join(map(str, c)))
                                  for c in RANDOM] + list(EDGE))
def test_nms_kernel_bit_identical(dev, case):
    """Random draws, and the edge cases: tile edges, max_out at a tile's
    end, mid-tile and above N, an all-invalid lane, 1, 4 and 8 lanes."""
    boxes, valid, thresh, max_out = _nms_case(case, dev)
    before = _n("nms.launches")
    ki, km = nms_cuda.nms_batched(boxes, valid, thresh, max_out)
    assert _n("nms.launches") == before + 1
    pi, pm = nms_padded(boxes, valid, thresh, max_out)
    assert torch.equal(ki, pi) and torch.equal(km, pm)


@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("case", [
    pytest.param((3, 700, 0.7, 128), id="3-700-0.7-128"),
    "invalid_lane_3x300_128", "max_out_mid_tile_2x200_100"])
def test_nms_kernel_any_cluster_size(dev, case, cluster):
    """Every cluster size (CTAs per lane) gives the same bits."""
    boxes, valid, thresh, max_out = _nms_case(case, dev)
    ki, km = nms_cuda._launch(boxes, valid, thresh, max_out, cluster)
    pi, pm = nms_padded(boxes, valid, thresh, max_out)
    assert torch.equal(ki, pi) and torch.equal(km, pm)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,gate,normalize", [(7, "sigmoid", True),
                                              (1, "multiply", False),
                                              (7, "multiply", True),
                                              (7, "multiply", False)])
def test_gate_kernel_matches_plain(dev, dtype, k, gate, normalize):
    g = torch.Generator().manual_seed(k)
    e, h, w, c = 3, 9, 20, 512
    conv = torch.randn((1, h, w, c), generator=g).to(dev, dtype)
    conv = conv.expand(e, h, w, c)
    filt = (torch.tanh(torch.randn((e, c, k), generator=g))
            * (1.0 if normalize else 0.05)).to(dev)
    rfilt = torch.tanh(torch.randn((e, k), generator=g)).to(dev)
    before = _n("gate.launches")
    gk, rk = fused_filter.fused_dynamic_filter(conv, filt, rfilt, k, gate,
                                               normalize)
    assert _n("gate.launches") == before + 1
    gp, rp = fused_dynamic_filter_plain(conv, filt, rfilt, k, gate, normalize)
    # f32 sums in another order: 1e-3 of the response's range; given the
    # kernel's response, the gated map is one rounding of conv * g, so it
    # may move by one ulp of dtype (f32: two, one more for the kernel's own
    # sigmoid)
    assert float((rk - rp).abs().max()) <= 1e-3 * float(rp.abs().max())
    g_k = torch.sigmoid(rk) if gate == "sigmoid" else rk
    want = (conv.float() * g_k).to(dtype).float()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    tol = ulp * want.abs() + 1e-30
    assert bool(((gk.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("maps,per_map", [(2, 3), (3, 4), (1, 5)])
def test_gate_kernel_reads_a_map_per_image(dev, dtype, maps, per_map):
    """exprs_per_map: expression e reads map e // per_map in place, to the
    tolerances above, one launch; the one-map case is the stride-0 call's
    bits."""
    g = torch.Generator().manual_seed(maps * 10 + per_map)
    e, h, w, c = maps * per_map, 9, 20, 512
    conv = torch.randn((maps, h, w, c), generator=g).to(dev, dtype)
    filt = torch.tanh(torch.randn((e, c, 7), generator=g)).to(dev)
    rfilt = torch.tanh(torch.randn((e, 7), generator=g)).to(dev)
    before = _n("gate.launches")
    gk, rk = fused_filter.fused_dynamic_filter(conv, filt, rfilt, 7,
                                               "sigmoid", True, per_map)
    assert _n("gate.launches") == before + 1
    gp, rp = fused_dynamic_filter_plain(conv, filt, rfilt, 7, "sigmoid",
                                        True, per_map)
    assert float((rk - rp).abs().max()) <= 1e-3 * float(rp.abs().max())
    rep = conv.repeat_interleave(per_map, 0)
    want = (rep.float() * torch.sigmoid(rk)).to(dtype).float()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    assert bool(((gk.float() - want).abs() <= ulp * want.abs() + 1e-30).all())
    gr, rr = fused_filter.fused_dynamic_filter(rep, filt, rfilt, 7,
                                               "sigmoid", True)
    assert torch.equal(gk, gr) and torch.equal(rk, rr)


def bf16_ulps_floored(got, want):
    """bf16 ulp distance, counted in ulps of max(|want|, 2^-8 max|want|).
    d_conv = d_gated * g + scale * (d_resp0 . filt) is rounded once to
    bf16 in both versions, but d_g inside d_resp0 is a sum over C in
    another order: where the two terms cancel, that f32 difference is
    many ulps of the small result, never of the 2^-8 floor."""
    want = want.float()
    mag = torch.maximum(want.abs(), want.abs().max() * 2.0 ** -8)
    ulp = 2.0 ** (torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want).abs() / ulp).max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,gate,normalize", [(7, "sigmoid", True),
                                              (1, "multiply", False),
                                              (7, "multiply", False),
                                              (7, "multiply", True)])
@pytest.mark.parametrize("c", [256, 1024])
def test_gate_bwd_kernel_matches_plain(dev, dtype, k, gate, normalize, c):
    """The backward kernel against its plain version, on a map gathered
    from 2 images (as in training) and on a stride-0 broadcast map."""
    g = torch.Generator().manual_seed(c + k)
    e, h, w = 5, 9, 20
    img = torch.randn((2, h, w, c), generator=g).to(dev, dtype)
    idx = torch.tensor([0, 1, 1, 0, 1], device=dev)
    filt = (torch.tanh(torch.randn((e, c, k), generator=g))
            * (1.0 if normalize else 0.05)).to(dev)
    rfilt = (torch.tanh(torch.randn((e, k), generator=g)) if k == 7
             else torch.ones((e, 1))).to(dev)
    d_gated = torch.randn((e, h, w, c), generator=g).to(dev, dtype)
    d_resp = torch.randn((e, h, w, 1), generator=g).to(dev)
    for conv in (img[idx], img[:1].expand(e, h, w, c)):
        _, fused = fused_dynamic_filter_plain(conv, filt, rfilt, k, gate,
                                              normalize)
        before = _n("gate.bwd_launches")
        got = fused_filter.fused_dynamic_filter_bwd(
            conv, filt, rfilt, fused, d_gated, d_resp, k, gate, normalize)
        assert _n("gate.bwd_launches") == before + 1
        want = fused_dynamic_filter_bwd_plain(
            conv, filt, rfilt, fused, d_gated, d_resp, k, gate, normalize)
        torch.cuda.synchronize()
        # d_conv: one rounding of an f32 value whose sums ran in another
        # order: 2 ulps of the map's dtype (f32: relative 1e-5)
        if dtype == torch.bfloat16:
            assert float(bf16_ulps_floored(got[0], want[0])) <= 2.0
        else:
            assert float((got[0] - want[0]).abs().max()) <= \
                1e-5 * float(want[0].abs().max())
        # d_filt, d_rfilt: f32 sums over the pixels in another order
        for a, b in zip(got[1:], want[1:]):
            assert float((a - b).abs().max()) <= \
                1e-3 * max(float(b.abs().max()), 1e-30)
        again = fused_filter.fused_dynamic_filter_bwd(
            conv, filt, rfilt, fused, d_gated, d_resp, k, gate, normalize)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


# (dtype, C) the kernels take at the edges of their tiling: a tile is 16 KB
# of map, 8 pixels of bf16 C = 1024 up to 32 of bf16 256 or f32 128
TILE_EDGE_MAPS = [(torch.bfloat16, 256), (torch.bfloat16, 512),
                  (torch.bfloat16, 1024), (torch.float32, 128),
                  (torch.float32, 1024)]


@pytest.mark.parametrize("maps", ["broadcast", "gathered"])
@pytest.mark.parametrize("e,h,w", [(1, 9, 20), (17, 9, 20), (2, 40, 64)])
@pytest.mark.parametrize("dtype,c", TILE_EDGE_MAPS,
                         ids=[f"{str(d)[6:]}-{c}" for d, c in TILE_EDGE_MAPS])
def test_gate_kernels_at_tile_edges(dev, dtype, c, e, h, w, maps):
    """Forward and backward at shapes that end mid-tile (9 x 20 = 180
    pixels), with 1 and 17 expressions (a grid of 1 to 15 blocks an
    expression), through a stride-0 map and a gathered one; the backward
    twice, for the same bits. The response is held within 1e-5 of its max
    as well as 1e-3: the bf16 forward's filter split in a hi and a lo
    bf16 part keeps it near f32, where a one-pass bf16 product would not."""
    g = torch.Generator().manual_seed(c + e)
    k = 7
    img = torch.randn((2, h, w, c), generator=g).to(dev, dtype)
    conv = (img[:1].expand(e, h, w, c) if maps == "broadcast" else
            img[torch.arange(e, device=dev) % 2])
    filt = torch.tanh(torch.randn((e, c, k), generator=g)).to(dev)
    rfilt = torch.tanh(torch.randn((e, k), generator=g)).to(dev)
    d_gated = torch.randn((e, h, w, c), generator=g).to(dev, dtype)
    d_resp = torch.randn((e, h, w, 1), generator=g).to(dev)
    gk, rk = fused_filter.fused_dynamic_filter(conv, filt, rfilt, k,
                                               "sigmoid", True)
    gp, rp = fused_dynamic_filter_plain(conv, filt, rfilt, k, "sigmoid", True)
    assert float((rk - rp).abs().max()) <= 1e-3 * float(rp.abs().max())
    assert float((rk - rp).abs().max()) <= 1e-5 * float(rp.abs().max())
    want = (conv.float() * torch.sigmoid(rk)).to(dtype).float()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    assert bool(((gk.float() - want).abs() <= ulp * want.abs() + 1e-30).all())
    args = (conv, filt, rfilt, rp, d_gated, d_resp, k, "sigmoid", True)
    got = fused_filter.fused_dynamic_filter_bwd(*args)
    want = fused_dynamic_filter_bwd_plain(*args)
    if dtype == torch.bfloat16:
        assert float(bf16_ulps_floored(got[0], want[0])) <= 2.0
    else:
        assert float((got[0] - want[0]).abs().max()) <= \
            1e-5 * float(want[0].abs().max())
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    again = fused_filter.fused_dynamic_filter_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype,c", TILE_EDGE_MAPS,
                         ids=[f"{str(d)[6:]}-{c}" for d, c in TILE_EDGE_MAPS])
def test_gate_plans_match_the_kernels(dev, dtype, c):
    """The tiling each kernel reports (a backward tile is 16 KB of each
    map) gives the flagship plan PERF.md states at C = 1024 bf16 on 132
    SMs; and the backward writes exactly the (e, blocks, c, k) d_filt and
    (e, blocks, k) d_rfilt partials of its plan: its scratch, taken from a
    NaN-filled buffer with a guard after it, is finite and the guard
    untouched."""
    elem = torch.empty((), dtype=dtype).element_size()
    tp, per_sm = fused_filter._tiling(True, c, dtype == torch.bfloat16)
    assert tp * c * elem == 16384 and per_sm == 2
    if dtype == torch.bfloat16 and c == 1024:
        bwd = fused_filter.tile_plan(16, 40, 64, tp, per_sm, 132)
        fwd = fused_filter.tile_plan(
            16, 40, 64, *fused_filter._tiling(False, c, True), 132)
        assert (tp, bwd["tiles_per_block"], bwd["grid"]) == (8, 20, (16, 16))
        assert (fwd["tile_pixels"], fwd["tiles_per_block"], fwd["grid"]) == \
            (16, 10, (16, 16))
    g = torch.Generator().manual_seed(c)
    e, h, w, k = 17, 9, 20, 7
    conv = torch.randn((e, h, w, c), generator=g).to(dev, dtype)
    filt = torch.tanh(torch.randn((e, c, k), generator=g)).to(dev)
    rfilt = torch.tanh(torch.randn((e, k), generator=g)).to(dev)
    d_gated = torch.randn((e, h, w, c), generator=g).to(dev, dtype)
    d_resp = torch.randn((e, h, w, 1), generator=g).to(dev)
    _, fused = fused_filter.fused_dynamic_filter(conv, filt, rfilt, k)
    plan = fused_filter.launch_plan("backward", conv)
    assert fused_filter.plans["forward"] == \
        fused_filter.launch_plan("forward", conv)
    blocks = plan["blocks_per_expr"]
    guard = 4096
    fpart = torch.full((e * blocks * c * k + guard,), float("nan"), device=dev)
    rpart = torch.full((e * blocks * k + guard,), float("nan"), device=dev)
    out = [torch.empty_like(conv), torch.empty((e, c, k), device=dev),
           torch.empty((e, k), device=dev)]
    rc = fused_filter._lib().fused_filter_bwd_launch(
        conv.data_ptr(), conv.stride(0), d_gated.data_ptr(), filt.data_ptr(),
        rfilt.data_ptr(), fused.data_ptr(), d_resp.data_ptr(), e, h, w, c, k,
        int(dtype == torch.bfloat16), 1, 1.0, blocks, fpart.data_ptr(),
        rpart.data_ptr(), *(t.data_ptr() for t in out),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    for part, n in ((fpart, e * blocks * c * k), (rpart, e * blocks * k)):
        assert bool(torch.isfinite(part[:n]).all())
        assert bool(torch.isnan(part[n:]).all())
    want = fused_dynamic_filter_bwd_plain(conv, filt, rfilt, fused, d_gated,
                                          d_resp, k, "sigmoid", False)
    for a, b in zip(out[1:], want[1:]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def test_gate_autograd_launches_both_kernels(dev):
    g = torch.Generator().manual_seed(0)
    e, h, w, c = 3, 8, 16, 512
    conv = torch.randn((e, h, w, c), generator=g).to(dev, torch.bfloat16)
    conv.requires_grad_(True)
    filt = torch.tanh(torch.randn((e, c, 7), generator=g)).to(dev)
    rfilt = torch.tanh(torch.randn((e, 7), generator=g)).to(dev)
    filt.requires_grad_(True)
    rfilt.requires_grad_(True)
    before = _counts(("gate.launches", "gate.bwd_launches"))
    gated, resp = fused_filter.fused_dynamic_filter(conv, filt, rfilt, 7,
                                                    "sigmoid", True)
    (gated.float().square().sum() + resp.sum()).backward()
    assert _since(before) == (1, 1)
    for t in (conv, filt, rfilt):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())


@pytest.mark.parametrize("normalize", [True, False])
def test_gate_bwd_takes_a_zero_d_resp(dev, normalize):
    """The `cycle` step: no loss reads the response, so the backward gets
    the zeros autograd materialises for it. The kernel's gradients against
    the plain version's at the training map's width, bf16, K=7 multiply."""
    g = torch.Generator().manual_seed(3)
    e, h, w, c, k = 4, 9, 20, 1024, 7
    img = torch.randn((2, h, w, c), generator=g).to(dev, torch.bfloat16)
    conv = img[torch.tensor([0, 1, 1, 0], device=dev)]
    filt = (torch.tanh(torch.randn((e, c, k), generator=g))
            * (1.0 if normalize else 0.03)).to(dev)
    rfilt = torch.tanh(torch.randn((e, k), generator=g)).to(dev)
    conv.requires_grad_(True)
    filt.requires_grad_(True)
    rfilt.requires_grad_(True)
    before = _n("gate.bwd_launches")
    gated, resp = fused_filter.fused_dynamic_filter(conv, filt, rfilt, k,
                                                    "multiply", normalize)
    d_gated = torch.randn(gated.shape, generator=g).to(dev, torch.bfloat16)
    gated.backward(d_gated)                    # resp takes no gradient
    assert _n("gate.bwd_launches") == before + 1
    want = fused_dynamic_filter_bwd_plain(
        conv.detach(), filt.detach(), rfilt.detach(), resp.detach(), d_gated,
        torch.zeros_like(resp), k, "multiply", normalize)
    assert float(bf16_ulps_floored(conv.grad, want[0])) <= 2.0
    for a, b in zip((filt.grad, rfilt.grad), want[1:]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


@pytest.mark.parametrize("maps", ["broadcast", "gathered"])
def test_gate_kernels_at_vgg_width(dev, maps):
    """The `vgg` variant's gate at full width, (16, 40, 64, 512) bf16, K=7
    sigmoid normalized, through a stride-0 map (serving) and a map
    gathered from 2 images (training), to chip_smoke phases 4 and 4b's
    tolerances: the response within 1e-5 of its max, the gated map 1 bf16
    ulp given the kernel's response and of the plain version's, d_conv 2
    bf16 ulps (floored), d_filt and d_rfilt 1e-3 of their max."""
    from lang2seg_tpu_torch.tools.profile_gate import (bf16_ulp_distance,
                                                       gate_inputs)
    e, h, w, c, k = 16, 40, 64, 512, 7
    conv, filt, rfilt, d_gated, d_resp = gate_inputs(e, h, w, c, k, maps,
                                                     dev, seed=5)
    gk, rk = fused_filter.fused_dynamic_filter(conv, filt, rfilt, k,
                                               "sigmoid", True)
    gp, rp = fused_dynamic_filter_plain(conv, filt, rfilt, k, "sigmoid", True)
    assert float((rk - rp).abs().max()) <= 1e-5 * float(rp.abs().max())
    same_g = (conv.float() * torch.sigmoid(rk)).to(torch.bfloat16)
    assert int(bf16_ulp_distance(gk.float(), same_g.float()).max()) <= 1
    assert int(bf16_ulp_distance(gk.float(), gp.float()).max()) <= 1
    args = (conv, filt, rfilt, rk, d_gated, d_resp, k, "sigmoid", True)
    got = fused_filter.fused_dynamic_filter_bwd(*args)
    want = fused_dynamic_filter_bwd_plain(*args)
    assert float(bf16_ulps_floored(got[0], want[0])) <= 2.0
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


@pytest.mark.parametrize("variant", ["response", "cycle", "cycle_response",
                                     "vgg", "response_att", "topdown",
                                     "mobilenet_pool"])
def test_tiny_train_step_card_vs_cpu(dev, variant):
    """One tiny f32 step (`tools/tiny_step.py`; VGG16 for `vgg`, its fc6
    / fc7 dropout drawn for both devices from one CPU generator;
    `response_att` with the attribute head, `topdown` the cycle_response
    step with the topdown decoder, `mobilenet_pool` MobileNetV1 with ROI
    max pooling) on the card and on the CPU from the
    same weights, draws and injected targets: the losses within
    1e-4 relative, the updates within 1e-3 in relative L2 norm and those
    whose exact gradient is zero within 1e-8 in norm (chip_smoke phases 8,
    10 and 25); the card's step launches the gate and its backward once
    each, and in pool mode the ROI pool kernel and its backward once
    each."""
    from lang2seg_tpu_torch.tools.tiny_step import card_vs_cpu
    torch.backends.cudnn.allow_tf32 = False
    errs, launched = card_vs_cpu(variant)
    pool = (1, 1) if variant == "mobilenet_pool" else (0, 0)
    assert launched == (0, 1, 1) + pool
    assert max(errs["loss_rel_err"].values()) <= 1e-4, errs["loss_rel_err"]
    assert errs["update_rel_err_max"] <= 1e-3, errs["worst"]
    assert not errs["moved_on_card_only"] and errs["tensors"] >= 40
    # a zero gradient in exact arithmetic: rounding only (tiny_step)
    assert errs["rounding_only_max"] <= 1e-8


def test_captioner_decodes_card_vs_cpu(dev):
    """The att2in2 captioner at full width (random weights, vocab 2000)
    decodes the same greedy and beam-10 words on the card as on the CPU,
    scores within 1e-3; its teacher-forced NLL within 1e-5 relative."""
    from lang2seg_tpu_torch.config import Config
    from lang2seg_tpu_torch.engine.train_captioner import init_captioner_state
    cfg = Config()
    g = torch.Generator().manual_seed(0)
    fc = torch.randn((4, 4096), generator=g)
    att = torch.relu(torch.randn((4, 196, 4096), generator=g))
    seq = torch.randint(1, 2000, (4, 12), generator=g)
    seq[:, 0] = 0
    mask = torch.ones((4, 12))
    out = {}
    for d in (dev, "cpu"):
        cap = init_captioner_state(cfg, device=d, seed=1).captioner.eval()
        a, b = fc.to(d), att.to(d)
        with torch.no_grad():
            nll = cap.teacher_forced_nll(a, b, seq.to(d), mask.to(d))
        out[str(d)] = (float(nll), *(t.cpu() for t in cap.sample_greedy(a, b)),
                       *(t.cpu() for t in cap.sample_beam(a, b, 10)))
    (nc, gc, lc, bc, sc), (np_, gp, lp, bp, sp) = out["cuda"], out["cpu"]
    assert abs(nc - np_) <= 1e-5 * abs(np_)
    assert torch.equal(gc, gp) and torch.equal(bc, bp)
    assert float((lc - lp).abs().max()) <= 1e-3
    assert float((sc - sp).abs().max()) <= 1e-3


def _tiny_refer():
    """The tiny f32 `response` config (resnet26, 128x192) and a mini
    REFER split built in memory: 3 train images and 1 val image."""
    from lang2seg_tpu_torch.config import Config, apply_variant
    from lang2seg_tpu_torch.data.fixtures import mini_refer_split
    cfg = apply_variant(Config(), "response")
    cfg.data.canvas_h, cfg.data.canvas_w = 128, 192
    cfg.model.backbone = "resnet26"
    cfg.model.compute_dtype = "float32"
    cfg.model.normalize_response = True
    cfg.train.learning_rate = 1e-5
    cfg.train.grad_clip_norm = 10.0
    cfg.train.rpn_pre_nms_top_n, cfg.train.rpn_post_nms_top_n = 512, 128
    cfg.train.roi_batch_size = 32
    cfg.test.rpn_pre_nms_top_n, cfg.test.rpn_post_nms_top_n = 256, 32
    cfg.train.expressions_per_batch = 4
    info, labels, read = mini_refer_split(
        ((120, 160), (160, 120), (120, 160), (160, 120)), (2, 2, 3, 3),
        ("train", "train", "train", "val"), seed=1)
    cfg.model.vocab_size = len(info["word_to_ix"])
    return cfg, info, labels, read


def test_loader_trainer_step_on_card(dev, tmp_path):
    """GtBatchLoader -> Trainer: one step on the card launches NMS, the
    gate and its backward once, and snapshots iter_1."""
    from lang2seg_tpu_torch.data.loader import GtBatchLoader
    from lang2seg_tpu_torch.engine.trainer import Trainer
    cfg, info, labels, read = _tiny_refer()
    tr = Trainer(cfg, GtBatchLoader(info, labels, cfg, read_image=read),
                 str(tmp_path), device="cuda")
    before = _counts(TRAINED)
    losses = tr.train(1)
    assert _since(before) == (1, 1, 1)
    assert all(np.isfinite(v) for v in losses.values())
    assert os.path.isdir(tmp_path / "ckpt" / "iter_1")


def test_eval_split_bucketed_image_on_card(dev):
    """eval_split of one val image (9 sentences) padded to the 16 bucket
    with the mask bank: NMS and the gate launch once; the card scores as
    the CPU."""
    from lang2seg_tpu_torch.data.loader import GtBatchLoader
    from lang2seg_tpu_torch.engine.evaluator import Evaluator
    from lang2seg_tpu_torch.models.network import build_model
    from lang2seg_tpu_torch.utils.metrics import SegEvalAccumulator
    from lang2seg_tpu_torch.weights import init_params
    cfg, info, labels, read = _tiny_refer()
    sd = init_params(cfg, 7)
    for k in ("rpn_cls_score_net.weight", "rpn_cls_score_net.bias"):
        sd[k] = sd[k] * 100.0
    batches = list(GtBatchLoader(info, labels, cfg, read_image=read)
                   .iter_test_batches("val", buckets=(4, 8, 16)))
    assert len(batches) == 1 and batches[0]["labels"].shape[0] == 16
    assert "gt_mask_bank" in batches[0]
    accs = {}
    for d in ("cuda", "cpu"):
        accs[d] = SegEvalAccumulator()
        before = _counts(SERVED)
        Evaluator(build_model(cfg, device=d, state_dict=sd), cfg,
                  device=d).eval_split(batches, acc=accs[d])
        launched = _since(before)
        assert launched == ((1, 1) if d == "cuda" else (0, 0))
    assert accs["cuda"].num_sent == accs["cpu"].num_sent == 9
    assert accs["cuda"].det_correct == accs["cpu"].det_correct
    assert abs(accs["cuda"].cum_i - accs["cpu"].cum_i) <= 4


def test_eval_split_chunks_on_card(dev):
    """Two images a dispatch (the val image twice, then the train images
    as val batches), staged and inline, the extent crop on: NMS and the
    gate once a dispatch, and the state of one image a dispatch."""
    from lang2seg_tpu_torch.data.loader import GtBatchLoader
    from lang2seg_tpu_torch.engine.evaluator import Evaluator
    from lang2seg_tpu_torch.models.network import build_model
    from lang2seg_tpu_torch.utils.metrics import SegEvalAccumulator
    from lang2seg_tpu_torch.weights import init_params
    cfg, info, labels, read = _tiny_refer()
    cfg.data.wire_extent_granularity = 32
    loader = GtBatchLoader(info, labels, cfg, read_image=read)
    batches = [loader.get_test_batch(sp, buckets=(8, 16))
               for sp in ("val", "train", "train", "train", "val")]
    sd = init_params(cfg, 7)
    for k in ("rpn_cls_score_net.weight", "rpn_cls_score_net.bias"):
        sd[k] = sd[k] * 100.0
    model = build_model(cfg, device="cuda", state_dict=sd)
    states = {}
    for k, staged in ((1, True), (2, True), (2, False)):
        acc = SegEvalAccumulator()
        ev = Evaluator(model, cfg)
        calls, real = [], ev._dispatch_staged

        def counted(st, real=real, calls=calls):
            c0 = _counts(SERVED)
            rec = real(st)
            calls.append(_since(c0))
            return rec

        ev._dispatch_staged = counted
        ev.eval_split(batches, images_per_dispatch=k, stage_uploads=staged,
                      acc=acc)
        assert calls and all(c == (1, 1) for c in calls)
        states[(k, staged)] = (acc.num_sent, acc.det_correct,
                               tuple(acc.seg_correct), acc.cum_i, acc.cum_u)
    assert states[(2, True)] == states[(2, False)]
    one, two = states[(1, True)], states[(2, True)]
    assert one[:3] == two[:3]
    assert abs(one[3] - two[3]) <= 4 * len(batches)
    assert abs(one[4] - two[4]) <= 4 * len(batches)


def test_nms_kernel_at_the_pretrain_shape(dev):
    """The pretraining step's NMS: 2 lanes (an example is an image) at
    12000 -> 2000, on an RPN draw: bit-identical, one launch."""
    from lang2seg_tpu_torch.tools.profile_nms import rpn_draw
    boxes = rpn_draw(2, 12000, 5, dev)
    valid = torch.ones((2, 12000), dtype=torch.bool, device=dev)
    before = _n("nms.launches")
    ki, km = nms_cuda.nms_batched(boxes, valid, 0.7, 2000)
    assert _n("nms.launches") == before + 1
    pi, pm = nms_padded(boxes, valid, 0.7, 2000)
    assert torch.equal(ki, pi) and torch.equal(km, pm)


def test_tiny_pretrain_step_card_vs_cpu(dev):
    """The tiny no-language step (2 images, 4 GT boxes and masks each,
    injected targets) on the card and on the CPU: losses within 1e-4
    relative, updates within 1e-3 in relative L2 norm (chip_smoke phase
    18); with targets injected and no language it launches no kernel."""
    from lang2seg_tpu_torch.tools.tiny_step import card_vs_cpu
    torch.backends.cudnn.allow_tf32 = False
    errs, launched = card_vs_cpu("pretrain")
    assert launched == (0, 0, 0, 0, 0)
    assert max(errs["loss_rel_err"].values()) <= 1e-4, errs["loss_rel_err"]
    assert errs["update_rel_err_max"] <= 1e-3, errs["worst"]
    assert not errs["moved_on_card_only"] and errs["tensors"] >= 20


def _tiny_raw_tree(root):
    """The raw REFER + COCO trees written by
    `data/fixtures.py::write_mini_refer` under `root`: (COCO instances
    path, read_image)."""
    from lang2seg_tpu_torch.data.fixtures import write_mini_refer
    coco, read = write_mini_refer(
        str(root), ((120, 160), (160, 120), (120, 160), (160, 120)),
        (2, 2, 3, 3), ("train", "train", "train", "val"), ((100, 140),),
        seed=4)
    return coco, read


def test_pretrain_step_from_the_coco_loader_on_card(dev, tmp_path):
    """CocoDetectionLoader (flips on, M = 4) -> to_wire -> train_step of
    the tiny `pretrain` model on the card: NMS launched once with 2
    lanes, the gate never; finite losses with loss_mask."""
    from lang2seg_tpu_torch.data.coco_detection import CocoDetectionLoader
    from lang2seg_tpu_torch.data.synthetic import to_wire
    from lang2seg_tpu_torch.engine.train_state import (create_train_state,
                                                       to_device, train_step)
    from lang2seg_tpu_torch.tools.tiny_step import tiny_config
    coco, read = _tiny_raw_tree(tmp_path)
    cfg = tiny_config("pretrain")
    cfg.train.learning_rate = 1e-5
    cfg.train.rpn_pre_nms_top_n, cfg.train.rpn_post_nms_top_n = 512, 128
    loader = CocoDetectionLoader(coco, str(tmp_path), cfg, read_image=read)
    state = create_train_state(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    before = _counts(TRAINED)
    losses = train_step(state, to_device(to_wire(cfg, loader.get_batch()),
                                         "cuda"), g)
    assert _since(before) == (1, 0, 0)
    assert "loss_mask" in losses and "loss_response" not in losses
    assert all(np.isfinite(float(v)) for v in losses.values())


def test_prepro_in_memory_feeds_a_response_step_on_card(dev, tmp_path):
    """The raw REFER tree -> REFER -> prepro_data (no h5py) ->
    GtBatchLoader -> one tiny `response` Trainer step on the card (NMS,
    the gate and its backward once)."""
    from lang2seg_tpu_torch.data.loader import GtBatchLoader
    from lang2seg_tpu_torch.data.prepro import prepro_data
    from lang2seg_tpu_torch.data.refer import REFER
    from lang2seg_tpu_torch.engine.trainer import Trainer
    _, read = _tiny_raw_tree(tmp_path)
    cfg, _, _, _ = _tiny_refer()
    info, labels = prepro_data(REFER(str(tmp_path)), cfg.data.max_len,
                               count_threshold=0)
    cfg.model.vocab_size = len(info["word_to_ix"])
    tr = Trainer(cfg, GtBatchLoader(info, labels, cfg, read_image=read),
                 device="cuda")
    before = _counts(TRAINED)
    losses = tr.train(1)
    assert _since(before) == (1, 1, 1)
    assert all(np.isfinite(v) for v in losses.values())


def test_attribute_scores_card_vs_cpu(dev):
    """predict_attribute_scores of the tiny f32 `response` model with the
    attribute head: the card's scores within 1e-5 of the CPU's, from the
    uint8 canvas."""
    from lang2seg_tpu_torch.engine.attributes import attribute_scorer
    from lang2seg_tpu_torch.models.network import build_model
    from lang2seg_tpu_torch.tools.tiny_step import tiny_config
    from lang2seg_tpu_torch.weights import init_params
    cfg = tiny_config("response_att")
    sd = init_params(cfg, 3)
    r = np.random.RandomState(0)
    img = r.randint(0, 256, (1, 128, 192, 3)).astype(np.uint8)
    boxes = np.asarray([[[4.0, 4.0, 60.0, 50.0], [10.0, 8.0, 90.0, 100.0],
                         [0.0, 0.0, 191.0, 127.0]]], np.float32)
    got = {d: attribute_scorer(build_model(cfg, device=d, state_dict=sd),
                               device=d)(img, boxes) for d in ("cuda", "cpu")}
    assert got["cuda"].shape == (1, 3, 6)
    assert np.abs(got["cuda"] - got["cpu"]).max() <= 1e-5


def test_comprehension_card_vs_cpu(dev):
    """ComprehensionEvaluator over the tiny split's val image on the card:
    the gate launches once and NMS never; the scores within 1e-4 of the
    CPU's."""
    from lang2seg_tpu_torch.data.loader import GtBatchLoader
    from lang2seg_tpu_torch.engine.comprehension import ComprehensionEvaluator
    from lang2seg_tpu_torch.models.network import build_model
    from lang2seg_tpu_torch.weights import init_params
    cfg, info, labels, read = _tiny_refer()
    sd = init_params(cfg, 5)
    b, = GtBatchLoader(info, labels, cfg, read_image=read).iter_test_batches(
        "val", buckets=(4, 8, 16))
    cands = np.unique(b["gt_boxes"][b["sent_valid"], :4], axis=0)
    e = b["labels"].shape[0]
    scores = {}
    for d in ("cuda", "cpu"):
        ev = ComprehensionEvaluator(build_model(cfg, device=d, state_dict=sd),
                                    cfg, device=d)
        before = _counts(SERVED)
        scores[d] = ev.score_boxes(
            torch.from_numpy(b["images"]).to(d),
            torch.from_numpy(b["labels"]).to(d),
            torch.from_numpy(np.broadcast_to(cands[None], (e,) + cands.shape)
                             .copy()).to(d)).cpu()
        launched = _since(before)
        assert launched == ((0, 1) if d == "cuda" else (0, 0))
        assert ev.eval_split([b])["n"] == 9
    assert float((scores["cuda"] - scores["cpu"]).abs().max()) <= 1e-4


@pytest.mark.parametrize("name", ["show_tell", "fc", "topdown",
                                  "show_attend_tell", "adaatt"])
def test_zoo_decoder_card_vs_cpu(dev, name):
    """Each zoo decoder at full width (512 wide, vocabulary 2000, 196
    attention positions of 4096): the teacher-forced NLL on the card
    within 1e-5 relative of the CPU's; in train mode with dropout
    (show_tell, fc) the card's draws keep about half an embedding, scaled
    by 2."""
    from lang2seg_tpu_torch.config import Config
    from lang2seg_tpu_torch.engine.train_captioner import init_captioner_state
    cfg = Config()
    cfg.model.caption_model = name
    g = torch.Generator().manual_seed(0)
    fc = torch.randn((4, 4096), generator=g)
    att = torch.relu(torch.randn((4, 196, 4096), generator=g))
    seq = torch.randint(1, 2000, (4, 12), generator=g)
    seq[:, 0] = 0
    mask = torch.ones((4, 12))
    nll = {}
    for d in ("cuda", "cpu"):
        cap = init_captioner_state(cfg, device=d, seed=1).captioner.eval()
        with torch.no_grad():
            nll[d] = float(cap.teacher_forced_nll(fc.to(d), att.to(d),
                                                  seq.to(d), mask.to(d)))
    assert abs(nll["cuda"] - nll["cpu"]) <= 1e-5 * abs(nll["cpu"])
    if name in ("show_tell", "fc"):
        x = torch.ones((4000, 64), device=dev)
        kept = cap._drop(x, torch.Generator(device=dev).manual_seed(2))
        assert abs(float((kept != 0).float().mean()) - 0.5) < 0.02
        assert set(torch.unique(kept).tolist()) == {0.0, 2.0}


def test_score_caption_split_on_card(dev):
    """cli.eval_captions.score_caption_split of the tiny f32 `cycle`
    model on the card: the seven metrics, finite."""
    from lang2seg_tpu_torch.cli.eval_captions import score_caption_split
    from lang2seg_tpu_torch.config import apply_variant
    from lang2seg_tpu_torch.data.loader import CycleBatchLoader
    from lang2seg_tpu_torch.models.network import build_model
    cfg, info, labels, read = _tiny_refer()
    apply_variant(cfg, "cycle")
    cfg.model.cap_vocab_size = cfg.model.vocab_size
    cfg.model.cap_rnn_size = cfg.model.cap_input_encoding_size = 64
    cfg.model.cap_att_hid_size = 64
    loader = CycleBatchLoader(info, labels, cfg, read_image=read)
    scores = score_caption_split(build_model(cfg, device="cuda"), loader,
                                 "val", beam_size=3)
    assert list(scores) == ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                            "ROUGE_L", "CIDEr", "METEOR"]
    assert all(np.isfinite(v) for v in scores.values())


def _check_roi_pool(feat, rois, grad):
    """The ROI pool kernels on (feat, rois) against the plain versions:
    the forward with and without the argmax and the decoded argmax bit for
    bit; the backward (f32 shared-memory atomics in no fixed order) within
    1 bf16 ulp, and in f32 within 1e-6 of max|d_feat|. Returns the codes
    and the plain argmax."""
    out, codes = roi_pool_cuda.roi_pool_forward(feat, rois, 7, 1 / 16)
    bare, _ = roi_pool_cuda.roi_pool_forward(feat, rois, 7, 1 / 16,
                                             with_argmax=False)
    want = roi_max_pool_plain(feat, rois, 7, 1 / 16)
    assert torch.equal(out, want) and torch.equal(bare, want)
    want_arg = roi_max_pool_argmax_plain(feat, rois, 7, 1 / 16)
    assert torch.equal(roi_pool_cuda.decode_argmax(codes, rois, 7, 1 / 16,
                                                   feat), want_arg)
    d = roi_pool_cuda.roi_pool_backward(grad.to(feat.dtype), codes, feat,
                                        rois, 7, 1 / 16)
    d_want = roi_max_pool_bwd_plain(feat, rois, grad.to(feat.dtype), 7,
                                    1 / 16)
    if feat.dtype == torch.bfloat16:
        assert int(bf16_ulp_distance(d, d_want).max()) <= 1
    else:
        assert float((d - d_want).abs().max()) <= 1e-6 * max(
            float(d_want.abs().max()), 1e-30)
    return codes, want_arg


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("maps", ["gathered", "broadcast"])
def test_roi_pool_kernel_matches_plain(dev, dtype, maps):
    """The ROI max-pool kernels against the plain versions on a small map
    with `profile_roi_pool.edge_rois`, the oversize ROI (bins rescanned by
    the backward) and windows of ties (chip_smoke phase 23 at the main
    path's shapes): the forward and the decoded argmax bit for bit; the
    backward within 1 bf16 ulp, in f32 within 1e-6 of max|d_feat|."""
    feat, rois, grad = roi_pool_inputs(3, 40, 20, 30, 64, maps, dev, dtype)
    codes, want_arg = _check_roi_pool(feat, rois, grad)
    assert codes.dtype == torch.uint8
    assert bool((want_arg < 0).any()) and bool((want_arg >= 0).any())
    assert bool((codes == 255).any())


@pytest.mark.parametrize("maps", ["gathered", "broadcast", "distinct"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [48, 96, 50])
def test_roi_pool_kernels_partial_slabs(dev, c, dtype, maps):
    """C not a multiple of a slab (48 and 96 channels against 16 or 8 a
    slab; 50 not a multiple of the 16-byte chunk, so every copy is a
    channel pair), on each kind of map, on the 40 x 64 map (swizzled
    slabs): the kernels against the plain versions."""
    feat, rois, grad = roi_pool_inputs(3, 24, 40, 64, c, maps, dev, dtype,
                                       seed=c)
    _check_roi_pool(feat, rois, grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_pool_kernels_mask_crops(dev, dtype):
    """E x 1 and E x 2 ROIs (the mask head's crops: a CTA's band holds a
    ROI's rows only) on 16 distinct 40 x 64 maps: on an H100 the few-ROI
    kernel at C = 64 in bf16 (64 CTAs) and at C = 512 (512 and 1024), the
    slab kernel at C = 64 in f32 (128)."""
    for r in (1, 2):
        for c in (64, 512):
            feat, rois, grad = roi_pool_inputs(16, r, 40, 64, c, "distinct",
                                               dev, dtype, seed=r)
            _check_roi_pool(feat, rois, grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_pool_few_roi_kernel_across_bands(dev, dtype):
    """The few-ROI forward on ROIs whose rectangle is the whole 40 x 64
    map (two bands of 24 rows): the oversize ROI (its large bins stored as
    255 and rescanned by the backward), the whole map and a 1 x 1 ROI, on
    gathered maps with windows of ties."""
    from lang2seg_tpu_torch.tools.profile_roi_pool import (edge_rois,
                                                           oversize_roi)
    feat, _, grad = roi_pool_inputs(2, 3, 40, 64, 48, "gathered", dev, dtype)
    edge = edge_rois(40, 64)
    rois = torch.stack([oversize_roi(40, 64), edge[7], edge[2]]).to(dev)
    rois = rois.expand(2, 3, 4)
    plan = roi_pool_cuda.slab_plan(40, 64, 48, dtype)
    assert roi_pool_cuda.forward_kernel(plan, 2, 3, 64, 7, 132)[0] == \
        "few_rois"
    codes, _ = _check_roi_pool(feat, rois, grad)
    assert bool((codes == 255).any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_pool_kernels_all_empty(dev, dtype):
    """ROIs all off the map: every output 0, every argmax -1, the map's
    gradient all 0 (written in full, from an uninitialised buffer)."""
    feat, _, grad = roi_pool_inputs(2, 8, 40, 64, 32, "gathered", dev, dtype)
    rois = torch.tensor([-300.0, -200.0, -40.0, -24.0], device=dev).expand(
        2, 8, 4)
    codes, want_arg = _check_roi_pool(feat, rois, grad)
    assert bool((want_arg == -1).all())
    d = roi_pool_cuda.roi_pool_backward(grad.to(dtype), codes, feat, rois, 7,
                                        1 / 16)
    assert not bool(d.any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,routes", [
    (120, 128, ("scan", "scan", "bands")),   # past the single-CTA slab
    (7, 1000, ("smem", "slab", "bands")),    # two-byte codes in shared memory
])
def test_roi_pool_kernels_large_maps(dev, dtype, h, w, routes):
    """Maps past the 40 x 64 plan: 120 x 128 takes the forward's global
    scan and the backward in bands of rows, 7 x 1000 the shared-memory
    forward (the slab kernel) with two-byte codes and the backward in
    bands; each launch counted under the kernel it ran."""
    plan = roi_pool_cuda.slab_plan(h, w, 48, dtype)
    assert plan["forward"]["route"] == routes[0]
    assert plan["code_dtype"] == torch.uint16
    assert plan["backward"]["route"] == routes[2]
    feat, rois, grad = roi_pool_inputs(2, 64, h, w, 48, "gathered", dev,
                                       dtype, seed=h)
    s0 = _shapes("roi_pool.launches"), _shapes("roi_pool.bwd_launches")
    _check_roi_pool(feat, rois, grad)
    assert _shapes("roi_pool.launches") - s0[0] == {roi_pool_cuda.shape_key(
        2, 64, 7, h, w, 48, dtype, True, routes[1]): 1,
        roi_pool_cuda.shape_key(2, 64, 7, h, w, 48, dtype, False,
                                routes[1]): 1}
    assert _shapes("roi_pool.bwd_launches") - s0[1] == {
        roi_pool_cuda.shape_key(2, 64, 7, h, w, 48, dtype, True,
                                routes[2]): 1}


def test_roi_pool_codes_match_their_plain_version(dev):
    """The codes the forward kernel writes, on the channels a map has,
    are `encode_argmax` of the plain argmax byte for byte (empty bins 0,
    the oversize ROI's large bins 255)."""
    feat, rois, _ = roi_pool_inputs(3, 40, 40, 64, 48, "gathered", dev)
    _, codes = roi_pool_cuda.roi_pool_forward(feat, rois, 7, 1 / 16)
    plan = roi_pool_cuda.slab_plan(40, 64, 48, feat.dtype)
    want = roi_pool_cuda.encode_argmax(
        roi_max_pool_argmax_plain(feat, rois, 7, 1 / 16), rois, 7, 1 / 16,
        40, 64, plan)
    assert torch.equal(codes, want)


def test_roi_max_pool_autograd_launches_both_kernels(dev):
    """`roi_max_pool` on the card launches the forward kernel and, under
    backward, the argmax backward, once each; no gradient reaches the
    ROIs."""
    feat, rois, _ = roi_pool_inputs(2, 16, 20, 30, 32, "gathered", dev)
    feat.requires_grad_(True)
    before = _counts(("roi_pool.launches", "roi_pool.bwd_launches"))
    roi_max_pool(feat, rois, 7, 1 / 16).float().square().sum().backward()
    assert _since(before) == (1, 1)
    want = roi_max_pool_bwd_plain(
        feat.detach(), rois, 2 * roi_max_pool_plain(
            feat.detach(), rois, 7, 1 / 16).float(), 7, 1 / 16)
    assert int(bf16_ulp_distance(feat.grad, want).max()) <= 1


@pytest.mark.parametrize("maps", ["gathered", "broadcast"])
def test_roi_max_pool_serving_writes_no_argmax(dev, maps):
    """Under no_grad `roi_max_pool` launches the forward kernel once
    without an argmax (its launch counted under that shape key) and gives
    the plain version's output bit for bit."""
    feat, rois, _ = roi_pool_inputs(3, 40, 20, 30, 64, maps, dev)
    s0 = _shapes("roi_pool.launches")
    with torch.no_grad():
        out = roi_max_pool(feat, rois, 7, 1 / 16)
    assert _shapes("roi_pool.launches") - s0 == {roi_pool_cuda.shape_key(
        3, 40, 7, 20, 30, 64, feat.dtype, False, "slab"): 1}
    assert out.grad_fn is None
    assert torch.equal(out, roi_max_pool_plain(feat, rois, 7, 1 / 16))


def test_demo_on_card(dev, tmp_path):
    """cli.demo on the card and with --device cpu, the tiny MobileNetV1
    pool config on the synthetic fixture: the same class, the box within
    1e-2 px, PNGs that decode to the annotated image."""
    from lang2seg_tpu_torch.cli import demo
    torch.backends.cudnn.allow_tf32 = False
    tiny = ["data.canvas_h", "128", "data.canvas_w", "192",
            "model.backbone", "mobilenet_v1", "model.c4_feat_dim", "512",
            "model.pooling_mode", "pool", "model.compute_dtype", "float32",
            "model.normalize_response", "true",
            "test.rpn_pre_nms_top_n", "256", "test.rpn_post_nms_top_n", "32"]
    got = {d: demo.main(["--device", d, "--out", str(tmp_path / f"{d}.png"),
                         "--set", *tiny]) for d in ("cuda", "cpu")}
    assert got["cuda"]["cls"] == got["cpu"]["cls"]
    assert np.abs(got["cuda"]["box"] - got["cpu"]["box"]).max() <= 1e-2
    for d in ("cuda", "cpu"):
        assert os.path.exists(got[d]["response"])


def _tiny_cfg():
    """The tiny f32 `response` config of the CPU tests (resnet26, 128 x
    192, 4 expressions), with an LR decay after step 2."""
    from lang2seg_tpu_torch.config import apply_variant, load_config
    cfg = load_config(None, [
        "data.canvas_h", "128", "data.canvas_w", "192", "model.backbone",
        "resnet26", "model.compute_dtype", "float32",
        "model.normalize_response", "true", "train.expressions_per_batch",
        "4", "train.stepsize", "[2]"])
    return apply_variant(cfg, "response")


@pytest.fixture
def deterministic(monkeypatch):
    """torch's deterministic algorithms for one test: in f32 the card's
    eager step is not the same twice (cuDNN's f32 convolution gradients;
    the bf16 steps of chip_smoke.py phase 28 are), so a graph cannot be
    held bit for bit against it without them."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_graphed_steps_equal_eager_steps(dev, deterministic):
    """make_multi_train_step on the card (a warm step, the capture, the
    replays; K = 3, two calls, an LR decay after step 2) against 6 eager
    train_steps from the same weights and generator seed, at the tiny f32
    config under deterministic algorithms: parameters, momentum, the
    generator and every loss bit for bit. The counters count the kernels
    the card ran: the first call's warm step and two replays (the capture
    none), and the second call's three replays, each kernel three times
    as its profiler trace runs them."""
    from lang2seg_tpu_torch.data.synthetic import synthetic_batch, to_wire
    from lang2seg_tpu_torch.engine.train_state import (
        create_train_state, make_multi_train_step, stack_batches, to_device,
        train_step)
    cfg = _tiny_cfg()
    batches = [to_wire(cfg, synthetic_batch(cfg, 2, 4, seed=s))
               for s in range(6)]
    eager = create_train_state(cfg, dev, seed=1)
    graphed = create_train_state(cfg, dev,
                                 state_dict=eager.model.state_dict())
    ge = torch.Generator(device=dev).manual_seed(3)
    gg = torch.Generator(device=dev).manual_seed(3)
    want = [train_step(eager, to_device(b, dev), ge) for b in batches]
    from torch.profiler import ProfilerActivity, profile

    from lang2seg_tpu_torch.tools.profile_eval import kernel_launches
    multi = make_multi_train_step(graphed, gg)
    assert multi.graphed
    c0 = _counts(TRAINED)
    got = [multi(to_device(stack_batches(batches[:3]), dev))]
    c1 = _counts(TRAINED)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got.append(multi(to_device(stack_batches(batches[3:]), dev)))
        torch.cuda.synchronize()
    traced = kernel_launches(prof)
    assert _since(c0, c1) == _since(c1) == (
        traced["nms"], traced["fused_filter"], traced["fused_filter_bwd"]) \
        == (3, 3, 3)
    for j, w in enumerate(want):
        for k, v in w.items():
            assert torch.equal(got[j // 3][k][j % 3], v), (j, k)
    for (n, a), b in zip(eager.model.state_dict().items(),
                         graphed.model.state_dict().values()):
        assert torch.equal(a, b), n
    for ga, gb in zip(eager.optimizer.param_groups,
                      graphed.optimizer.param_groups):
        for p, q in zip(ga["params"], gb["params"]):
            assert torch.equal(eager.optimizer.state[p]["momentum_buffer"],
                               graphed.optimizer.state[q]["momentum_buffer"])
    assert torch.equal(ge.get_state(), gg.get_state())
    with pytest.raises(ValueError, match="captured"):
        multi(to_device(stack_batches([to_wire(cfg, synthetic_batch(
            cfg, 2, 2, seed=0))] * 2), dev))


def test_row_gather_is_deterministic_on_card(dev):
    """The mask head's class gather (a one-hot product): index_select's
    logits; the class weights' and biases' gradients the same bits on
    every call (CUDA's index_select backward is not), and index_select's
    up to the order of each class's sum."""
    from lang2seg_tpu_torch.models.heads import MaskHead
    torch.manual_seed(0)
    head = MaskHead(in_features=256, num_classes=81, features=64).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((512, 7, 7, 256), generator=g, device=dev)
    labels = torch.randint(0, 81, (512,), generator=g, device=dev)
    cot = torch.randn((512, 14, 14), generator=g, device=dev)
    w, bias = head.mask_pred_net.weight, head.mask_pred_net.bias

    def plain():
        up = head.mask_up_sampling
        y = torch.matmul(x.reshape(-1, 256), up.weight.reshape(256, 256))
        y = y.reshape(512, 7, 7, 64, 2, 2).permute(0, 1, 4, 2, 5, 3)
        y = torch.relu(y.reshape(512, 14, 14, 64) + up.bias)
        kcol = w[:, :, 0, 0].index_select(0, labels)
        return torch.einsum("rhwf,rf->rhw", y, kcol) + \
            bias.index_select(0, labels)[:, None, None]
    assert torch.equal(head(x, labels), plain())
    grads = [torch.autograd.grad((head(x, labels) * cot).sum(), (w, bias))
             for _ in range(3)]
    for a, b in zip(grads[0], grads[1]):
        assert torch.equal(a, b)
    for a, b in zip(grads[0], grads[2]):
        assert torch.equal(a, b)
    want = torch.autograd.grad((plain() * cot).sum(), (w, bias))
    for a, b in zip(grads[0], want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)


def test_trainer_graphed_groups_equal_single_steps(dev, deterministic,
                                                   tmp_path):
    """The Trainer at steps_per_dispatch 2 on the card, with snapshots
    every 3 and an LR decay at 5 over 7 steps: groups [2], [1], [2], [1],
    [1], so the graph is captured, eager steps run between its replays
    and snapshots are written with the graph alive. Against the Trainer
    at 1, bit for bit: parameters, momentum, the generator, and each
    snapshot's model, optimizer, step, generator and loader state."""
    from lang2seg_tpu_torch.data.synthetic import (FixedBatchLoader,
                                                  synthetic_batch, to_wire)
    from lang2seg_tpu_torch.engine.checkpoint import CheckpointManager
    from lang2seg_tpu_torch.engine.trainer import Trainer
    cfg = _tiny_cfg()
    cfg.train.stepsize = (5,)
    cfg.train.snapshot_iters = 3
    cfg.train.snapshot_kept = 10
    batches = [to_wire(cfg, synthetic_batch(cfg, 2, 4, seed=s))
               for s in range(7)]
    runs = {}
    for k in (1, 2):
        c = copy.deepcopy(cfg)
        c.train.steps_per_dispatch = k
        tr = Trainer(c, FixedBatchLoader(batches), str(tmp_path / f"k{k}"),
                     device=dev, seed=1)
        tr.train(7)
        runs[k] = tr
    a, b = runs[1].state, runs[2].state
    assert runs[2].multi_step.graph is not None
    for (n, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), n
    for ga, gb in zip(a.optimizer.param_groups, b.optimizer.param_groups):
        assert ga["lr"] == gb["lr"]
        for p, q in zip(ga["params"], gb["params"]):
            assert torch.equal(a.optimizer.state[p]["momentum_buffer"],
                               b.optimizer.state[q]["momentum_buffer"])
    assert torch.equal(runs[1].generator.get_state(),
                       runs[2].generator.get_state())
    ckpts = {k: CheckpointManager(str(tmp_path / f"k{k}" / "ckpt"))
             for k in (1, 2)}
    for it in (3, 5, 6, 7):
        (sa, ha), (sb, hb) = (ckpts[k].restore(it) for k in (1, 2))
        assert sa["step"] == sb["step"] == it
        assert ha["loader_state"] == hb["loader_state"] == {"position": it}
        assert torch.equal(sa["generator"], sb["generator"])
        for n, x in sa["model"].items():
            assert torch.equal(x, sb["model"][n]), (it, n)
        for i, st in sa["optimizer"]["state"].items():
            assert torch.equal(st["momentum_buffer"],
                               sb["optimizer"]["state"][i]["momentum_buffer"])


# ---------------------------------------------------------------------------
# the ROI crop kernels (csrc/roi_crop.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("maps", ["gathered", "broadcast", "distinct"])
@pytest.mark.parametrize("c,s", [(64, 7), (24, 7), (64, 14)])
def test_roi_crop_kernels_match_plain(dev, dtype, maps, c, s):
    """The crop kernels against their plain versions on small maps with
    the edge ROIs (`profile_crop.compare_shape`): the forward bit for bit
    against its algorithm in torch ops and within `FWD_ULPS` of the einsum
    pair, the backward bit for bit against its fixed-order plain version,
    the same bits on a second run, and within `BWD_ULPS` of autograd of
    the einsum pair; a partial channel slab (C = 24) and the 14 x 14 crop
    of `max_pool`."""
    from lang2seg_tpu_torch.tools.profile_crop import (checks_pass,
                                                       compare_shape)
    res, _ = compare_shape(3, 20, 20, 30, c, maps, dev, True, seed=4,
                           dtype=dtype, s=s)
    assert res["forward_gather_equal"] and res["bwd_plain_equal"] and \
        res["bwd_repeat_equal"], res
    assert checks_pass(res), res


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_crop_kernels_in_bands(dev, dtype):
    """A map larger than the full-width paths' (120 x 128: a warp of the
    backward for each 4 pixels of a row, 3,840 a slab and expression), with
    the crop kernels against their plain versions as above."""
    from lang2seg_tpu_torch.tools.profile_crop import (checks_pass,
                                                       compare_shape)
    assert roi_crop_cuda.band_plan(120, 128, 48, dtype, 7, 2)["ctas"] == 3840
    res, _ = compare_shape(2, 40, 120, 128, 48, "gathered", dev, True,
                           seed=5, dtype=dtype)
    assert checks_pass(res), res


def _one_cell_rois(e):
    """(e, 5, 4) ROIs whose 7 x 7 samples all fall in map cell (4, 8) at
    stride 16."""
    x1 = 130.0 + torch.arange(5, dtype=torch.float32)
    return torch.stack([x1, torch.full_like(x1, 70.0), x1 + 3.0,
                        torch.full_like(x1, 71.0)], -1).expand(e, 5, 4)


def _crowded_rois(r):
    """(1, r, 4) ROIs that all reach map rows 9-11 (flat, at stride 16),
    spread over the columns: every warp of those rows takes many batches
    of 32."""
    k = torch.arange(r, dtype=torch.float32)
    x1 = (k * 37.0) % 900.0
    y1 = 150.0 + k % 8
    return torch.stack([x1, y1, x1 + 10.0 + (k * 13.0) % 300.0, y1 + 20.0],
                       -1)[None]


# (name, E, R, H, W, C, maps, dtype, S, ROIs: None for drawn proposals)
CROP_EDGE_CASES = [
    ("one_cell", 2, 5, 20, 30, 64, "gathered", torch.bfloat16, 7,
     _one_cell_rois(2)),
    ("crowded_row", 1, 700, 20, 64, 64, "gathered", torch.bfloat16, 7,
     _crowded_rois(700)),
    ("r33", 2, 33, 20, 30, 64, "gathered", torch.bfloat16, 7, None),
    ("r1", 3, 1, 20, 30, 64, "gathered", torch.bfloat16, 7, None),
    ("c24", 2, 40, 20, 30, 24, "gathered", torch.bfloat16, 7, None),
    ("s14", 2, 40, 20, 30, 64, "gathered", torch.bfloat16, 14, None),
    ("f32", 2, 40, 20, 30, 64, "gathered", torch.float32, 7, None),
    ("wide_two_slabs", 2, 60, 120, 128, 264, "gathered", torch.bfloat16, 7,
     None),
    ("broadcast", 3, 40, 20, 30, 64, "broadcast", torch.bfloat16, 7, None),
    ("four_pixel_warps", 16, 20, 40, 64, 256, "gathered", torch.bfloat16, 7,
     None),
    ("four_pixel_one_cell", 16, 5, 40, 64, 256, "gathered", torch.float32,
     7, _one_cell_rois(16)),
]


@pytest.mark.parametrize("case", CROP_EDGE_CASES, ids=lambda c: c[0])
def test_roi_crop_kernels_on_edge_layouts(dev, case):
    """The crop kernels bit for bit against their algorithms in torch ops
    (the forward against `crop_gather_plain`, the backward against
    `crop_bwd_coords_plain`) and the backward against itself on a second
    run: a ROI whose samples all fall in one cell, 700 ROIs reaching one
    row (22 batches of 32 for each warp there), R not a multiple of 32 and
    R = 1, a partial channel slab (C = 24), S = 14, f32 maps, a map of
    many warps and two slabs (the second partial), a stride-0 map read by
    every expression (the forward); the two-slab map and the last two (16
    expressions of 40 x 64 maps) launch a warp for each 4 pixels, the rest
    a warp a pixel (`band_plan`)."""
    from lang2seg_tpu_torch.ops.roi_align import (crop_bwd_coords_plain,
                                                  crop_gather_plain)
    from lang2seg_tpu_torch.tools.profile_crop import coords, crop_inputs
    name, e, r, h, w, c, maps, dtype, s, rois = case
    assert roi_crop_cuda.band_plan(h, w, c, dtype, s, e)["pixels"] == \
        (4 if name in ("wide_two_slabs", "four_pixel_warps",
                       "four_pixel_one_cell") else 1)
    feat, drawn, grad = crop_inputs(e, r, h, w, c, maps, dev, dtype, seed=6,
                                    s=s)
    ys, xs = coords(drawn if rois is None else rois.to(dev), s)
    out = roi_crop_cuda.launch_forward(feat, ys, xs)
    assert torch.equal(out, crop_gather_plain(feat, ys, xs))
    d1 = roi_crop_cuda.launch_backward(grad, ys, xs, h, w)
    d2 = roi_crop_cuda.launch_backward(grad, ys, xs, h, w)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(d1.view(bits), d2.view(bits))
    assert torch.equal(d1, crop_bwd_coords_plain(grad, ys, xs, h, w))
    assert bool(d1.ne(0).any())


def test_roi_crop_autograd_launches_both_kernels(dev):
    """`roi_crop_pool` on the card with a map that wants a gradient
    launches the forward kernel once and, under backward, the backward
    kernel once (each counted by shape); under no_grad the forward alone.
    The results are the plain versions' bits."""
    from lang2seg_tpu_torch.ops.roi_align import (_sample_coords,
                                                  crop_bwd_coords_plain,
                                                  crop_gather_plain,
                                                  roi_crop_pool)
    from lang2seg_tpu_torch.tools.profile_crop import crop_inputs
    feat, rois, grad = crop_inputs(2, 16, 20, 30, 64, "gathered", dev)
    ys, xs = (t.contiguous() for t in _sample_coords(rois, 7, 1 / 16))
    before = _counts(CROPS)
    key = roi_crop_cuda.shape_key(2, 16, 7, 20, 30, 64, torch.bfloat16)
    shapes = (_shapes("roi_crop.launches")[key],
              _shapes("roi_crop.bwd_launches")[key])
    leaf = feat.detach().requires_grad_(True)
    out = roi_crop_pool(leaf, rois, 7, 1 / 16)
    out.backward(grad)
    assert _since(before) == (1, 1)
    assert (_shapes("roi_crop.launches")[key],
            _shapes("roi_crop.bwd_launches")[key]) == \
        (shapes[0] + 1, shapes[1] + 1)
    assert torch.equal(out, crop_gather_plain(feat, ys, xs))
    assert torch.equal(leaf.grad, crop_bwd_coords_plain(grad, ys, xs, 20,
                                                        30))
    with torch.no_grad():
        served = roi_crop_pool(leaf, rois, 7, 1 / 16)
    assert served.grad_fn is None and torch.equal(served, out)
    assert _since(before) == (2, 1)


def test_roi_crop_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """C not a multiple of 8, a map whose pixels are not contiguous,
    coordinates of another shape or dtype, S past 16: each raises before
    any launch."""
    feat = torch.zeros((2, 8, 12, 64), device=dev, dtype=torch.bfloat16)
    ys = torch.zeros((2, 3, 7), device=dev)
    before = _n("roi_crop.launches")
    for bad in (feat[..., :12], feat[:, :, ::2]):
        with pytest.raises(ValueError):
            roi_crop_cuda.roi_crop_forward(bad, ys, ys)
    for y, x in ((ys, ys[:, :2]), (ys.double(), ys.double()),
                 (torch.zeros((2, 3, 17), device=dev),) * 2):
        with pytest.raises(ValueError):
            roi_crop_cuda.roi_crop_forward(feat, y, x)
    assert _n("roi_crop.launches") == before


def test_graphed_step_replays_the_crop_kernels(dev, deterministic):
    """The tiny f32 step as a CUDA graph (K = 2, two calls) against 4
    eager steps, bit for bit, with the crop kernels inside the graph: the
    first call counts its warm step and one replay (the capture nothing),
    the second its two replays, each kernel as often as its profiler trace
    runs it."""
    from torch.profiler import ProfilerActivity, profile

    from lang2seg_tpu_torch.data.synthetic import synthetic_batch, to_wire
    from lang2seg_tpu_torch.engine.train_state import (
        create_train_state, make_multi_train_step, stack_batches, to_device,
        train_step)
    from lang2seg_tpu_torch.tools.profile_eval import kernel_launches
    cfg = _tiny_cfg()
    batches = [to_wire(cfg, synthetic_batch(cfg, 2, 4, seed=s))
               for s in range(4)]
    eager = create_train_state(cfg, dev, seed=1)
    graphed = create_train_state(cfg, dev,
                                 state_dict=eager.model.state_dict())
    ge = torch.Generator(device=dev).manual_seed(3)
    gg = torch.Generator(device=dev).manual_seed(3)
    want = [train_step(eager, to_device(b, dev), ge) for b in batches]
    multi = make_multi_train_step(graphed, gg)
    c0 = _counts(CROPS)
    got = [multi(to_device(stack_batches(batches[:2]), dev))]
    c1 = _counts(CROPS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got.append(multi(to_device(stack_batches(batches[2:]), dev)))
        torch.cuda.synchronize()
    traced = kernel_launches(prof)
    assert _since(c0, c1) == _since(c1) == (
        traced["roi_crop"], traced["roi_crop_bwd"]) == (2, 2)
    for j, w in enumerate(want):
        for k, v in w.items():
            assert torch.equal(got[j // 2][k][j % 2], v), (j, k)
    for (n, a), b in zip(eager.model.state_dict().items(),
                         graphed.model.state_dict().values()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# frozen BatchNorm + residual + ReLU (csrc/bn_act.cu)
# ---------------------------------------------------------------------------

def _bn_act_case(n, c, h, w, dtype, dev, seed):
    """x, the residual / x_d (channels_last, with -0 and +0 entries), and
    two FrozenBatchNorms of non-unit statistics whose channel 0 gives -0
    before the ReLU (weight > 0, bias -0, mean 0) and channel 1 a negative
    scale."""
    from lang2seg_tpu_torch.tools.profile_bn_act import random_bn
    g = torch.Generator().manual_seed(seed)
    bns = []
    for _ in range(2):
        bn = random_bn(c, g, "cpu")
        bn.weight[0], bn.bias[0], bn.running_mean[0] = 1.0, -0.0, 0.0
        bn.weight[1] = -abs(float(bn.weight[1]))
        bns.append(bn.to(dev))
    acts = []
    for _ in range(2):
        t = torch.randn((n, c, h, w), generator=g) * 3
        t[:, 0, ::2] = -0.0
        t[:, :, 1::3, 1::2] = 0.0
        acts.append(t.to(dev, dtype, memory_format=torch.channels_last))
    return acts, bns


BN_ACT_BF16 = [(4800, 512, 7, 7, "relu"), (4800, 2048, 7, 7, "residual"),
               (4800, 2048, 7, 7, "down"), (2, 256, 40, 64, "relu"),
               (2, 1024, 40, 64, "residual"), (2, 1024, 40, 64, "down"),
               (1, 64, 320, 512, "relu")]
BN_ACT_BOTH = [(3, 24, 5, 7, v) for v in ("relu", "residual", "down")] + [
    (2, 2048, 7, 7, "down"), (1, 64, 13, 17, "relu")]


@pytest.mark.parametrize("case", [
    pytest.param((*c, torch.bfloat16), id="-".join(map(str, c)) + "-bf16")
    for c in BN_ACT_BF16 + BN_ACT_BOTH] + [
    pytest.param((*c, torch.float32), id="-".join(map(str, c)) + "-f32")
    for c in BN_ACT_BOTH])
def test_bn_act_kernels_match_plain(dev, case):
    """The forward and backward kernels against the plain composition
    under autograd, bit for bit (signed zeros included): layer4 at serving
    (4,800 crops of 7 x 7, C = 512 and 2048), layer3 and stem maps, C = 24
    (3 bf16 vectors a pixel) on 105 pixels, C = 2048 in f32 (512 vectors
    a pixel)."""
    from lang2seg_tpu_torch.ops import bn_act_cuda
    n, c, h, w, variant, dtype = case
    (x0, o0), (bn, bn_d) = _bn_act_case(n, c, h, w, dtype, dev, c + n)
    up = (torch.randn((n, c, h, w), generator=torch.Generator()
                      .manual_seed(9)) * 2).to(dev, dtype)
    results = []
    for op in (bn_act_cuda.bn_act, bn_act_cuda.bn_act_plain):
        x, other = (t.clone().requires_grad_(True) for t in (x0, o0))
        kw = {"relu": {}, "residual": {"residual": other},
              "down": {"down": (other, bn_d)}}[variant]
        before = _counts(BN_ACT)
        out = op(x, bn, **kw)
        out.backward(up)
        torch.cuda.synchronize()
        if op is bn_act_cuda.bn_act:
            assert _since(before) == (1, 1)
            assert out.is_contiguous(memory_format=torch.channels_last)
        results.append([out.detach(), x.grad] + (
            [] if variant == "relu" else [other.grad]))
    assert bool((results[1][0] == 0).any())
    for a, b in zip(*results):
        assert same_bits(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_act_gradients_only_where_needed(dev, dtype):
    """A residual that needs no gradient gets none (the kernel writes
    only x's); under no_grad the forward launches alone, with no graph."""
    from lang2seg_tpu_torch.ops import bn_act_cuda
    (x0, o0), (bn, _) = _bn_act_case(2, 64, 9, 11, dtype, dev, 3)
    x = x0.clone().requires_grad_(True)
    out = bn_act_cuda.bn_act(x, bn, residual=o0)
    out.sum().backward()
    xp = x0.clone().requires_grad_(True)
    bn_act_cuda.bn_act_plain(xp, bn, residual=o0).sum().backward()
    assert same_bits(x.grad, xp.grad)
    before = _counts(BN_ACT)
    with torch.no_grad():
        out = bn_act_cuda.bn_act(x, bn, residual=o0)
    assert out.grad_fn is None
    assert _since(before) == (1, 0)


def test_bn_act_refuses_what_the_kernel_does_not_take(dev):
    """NCHW-contiguous maps, C not a whole number of 16-byte vectors and a
    mismatched residual raise; nothing falls back."""
    from lang2seg_tpu_torch.ops import bn_act_cuda
    (x, o), (bn, _) = _bn_act_case(2, 64, 5, 6, torch.bfloat16, dev, 4)
    with pytest.raises(ValueError, match="channels_last"):
        bn_act_cuda.bn_act(x.contiguous(), bn)
    (x12, _), (bn12, _) = _bn_act_case(2, 12, 5, 6, torch.bfloat16, dev, 5)
    with pytest.raises(ValueError, match="multiple of 8"):
        bn_act_cuda.bn_act(x12, bn12)
    with pytest.raises(ValueError, match="must match"):
        bn_act_cuda.bn_act(x, bn, residual=o.float())


def test_bn_act_counts_by_shape_and_rechecks_new_buffers(dev):
    """The wrapper counts each launch at its (N, C, H, W, mode, dtype);
    it keeps a BatchNorm's checked buffer pointers only while the same
    buffer tensors, C and device come back: a buffer replaced by another
    tensor is read through its new pointer, a replacement of the wrong
    dtype and a map of another C are refused."""
    from lang2seg_tpu_torch.ops import bn_act_cuda
    (x, o), (bn, _) = _bn_act_case(2, 64, 5, 6, torch.bfloat16, dev, 6)
    key = bn_act_cuda.shape_key(x, 1)
    assert key == (2, 64, 5, 6, 1, "bfloat16")
    before = _shapes("bn_act.launches")[key]
    with torch.no_grad():
        first = bn_act_cuda.bn_act(x, bn, residual=o)
        assert _shapes("bn_act.launches")[key] == before + 1
        bn.running_var = bn.running_var * 4 + 1
        got = bn_act_cuda.bn_act(x, bn, residual=o)
        assert same_bits(got, bn_act_cuda.bn_act_plain(x, bn, residual=o))
        assert not same_bits(got, first)
        bn.running_var = bn.running_var.double()
        with pytest.raises(ValueError, match="buffers"):
            bn_act_cuda.bn_act(x, bn)
        bn.running_var = bn.running_var.float()
        (x128, _), _ = _bn_act_case(2, 128, 5, 6, torch.bfloat16, dev, 7)
        with pytest.raises(ValueError, match="buffers"):
            bn_act_cuda.bn_act(x128, bn)
