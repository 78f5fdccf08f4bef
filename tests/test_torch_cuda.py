"""CUDA kernels of the PyTorch port against their plain versions, on the
card. These tests need an NVIDIA GPU with nvcc (the kernels have no
CPU mode) and skip without one; they import nothing of JAX, so they run
on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

`chip_smoke.py` runs the same comparisons at the flagship shapes."""

import os

import numpy as np
import pytest
import torch

from lang2seg_tpu_torch.ops import fused_filter, nms_cuda
from lang2seg_tpu_torch.ops.fused_filter import (
    fused_dynamic_filter_bwd_plain, fused_dynamic_filter_plain)
from lang2seg_tpu_torch.ops.nms import nms_padded
from lang2seg_tpu_torch.tools.profile_nms import edge_cases

pytestmark = pytest.mark.cuda


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
    before = nms_cuda.launches
    ki, km = nms_cuda.nms_batched(boxes, valid, thresh, max_out)
    assert nms_cuda.launches == before + 1
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
    before = fused_filter.launches
    gk, rk = fused_filter.fused_dynamic_filter(conv, filt, rfilt, k, gate,
                                               normalize)
    assert fused_filter.launches == before + 1
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
        before = fused_filter.bwd_launches
        got = fused_filter.fused_dynamic_filter_bwd(
            conv, filt, rfilt, fused, d_gated, d_resp, k, gate, normalize)
        assert fused_filter.bwd_launches == before + 1
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
    f0, b0 = fused_filter.launches, fused_filter.bwd_launches
    gated, resp = fused_filter.fused_dynamic_filter(conv, filt, rfilt, 7,
                                                    "sigmoid", True)
    (gated.float().square().sum() + resp.sum()).backward()
    assert (fused_filter.launches - f0, fused_filter.bwd_launches - b0) \
        == (1, 1)
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
    before = fused_filter.bwd_launches
    gated, resp = fused_filter.fused_dynamic_filter(conv, filt, rfilt, k,
                                                    "multiply", normalize)
    d_gated = torch.randn(gated.shape, generator=g).to(dev, torch.bfloat16)
    gated.backward(d_gated)                    # resp takes no gradient
    assert fused_filter.bwd_launches == before + 1
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
                                     "vgg", "response_att", "topdown"])
def test_tiny_train_step_card_vs_cpu(dev, variant):
    """One tiny f32 step (`tools/tiny_step.py`; VGG16 for `vgg`, its fc6
    / fc7 dropout drawn for both devices from one CPU generator;
    `response_att` with the attribute head, `topdown` the cycle_response
    step with the topdown decoder) on the card and on the CPU from the
    same weights, draws and injected targets: the losses within
    1e-4 relative, the updates within 1e-3 in relative L2 norm and those
    whose exact gradient is zero within 1e-8 in norm (chip_smoke phases 8
    and 10); the card's step launches the gate and its backward once
    each."""
    from lang2seg_tpu_torch.tools.tiny_step import card_vs_cpu
    torch.backends.cudnn.allow_tf32 = False
    errs, launched = card_vs_cpu(variant)
    assert launched == (0, 1, 1)
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
    before = (nms_cuda.launches, fused_filter.launches,
              fused_filter.bwd_launches)
    losses = tr.train(1)
    after = (nms_cuda.launches, fused_filter.launches,
             fused_filter.bwd_launches)
    assert tuple(b - a for a, b in zip(before, after)) == (1, 1, 1)
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
        before = (nms_cuda.launches, fused_filter.launches)
        Evaluator(build_model(cfg, device=d, state_dict=sd), cfg,
                  device=d).eval_split(batches, acc=accs[d])
        launched = (nms_cuda.launches - before[0],
                    fused_filter.launches - before[1])
        assert launched == ((1, 1) if d == "cuda" else (0, 0))
    assert accs["cuda"].num_sent == accs["cpu"].num_sent == 9
    assert accs["cuda"].det_correct == accs["cpu"].det_correct
    assert abs(accs["cuda"].cum_i - accs["cpu"].cum_i) <= 4


def test_nms_kernel_at_the_pretrain_shape(dev):
    """The pretraining step's NMS: 2 lanes (an example is an image) at
    12000 -> 2000, on an RPN draw: bit-identical, one launch."""
    from lang2seg_tpu_torch.tools.profile_nms import rpn_draw
    boxes = rpn_draw(2, 12000, 5, dev)
    valid = torch.ones((2, 12000), dtype=torch.bool, device=dev)
    before = nms_cuda.launches
    ki, km = nms_cuda.nms_batched(boxes, valid, 0.7, 2000)
    assert nms_cuda.launches == before + 1
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
    assert launched == (0, 0, 0)
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
    before = (nms_cuda.launches, fused_filter.launches,
              fused_filter.bwd_launches)
    losses = train_step(state, to_device(to_wire(cfg, loader.get_batch()),
                                         "cuda"), g)
    after = (nms_cuda.launches, fused_filter.launches,
             fused_filter.bwd_launches)
    assert tuple(b - a for a, b in zip(before, after)) == (1, 0, 0)
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
    before = (nms_cuda.launches, fused_filter.launches,
              fused_filter.bwd_launches)
    losses = tr.train(1)
    after = (nms_cuda.launches, fused_filter.launches,
             fused_filter.bwd_launches)
    assert tuple(b - a for a, b in zip(before, after)) == (1, 1, 1)
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
        before = (nms_cuda.launches, fused_filter.launches)
        scores[d] = ev.score_boxes(
            torch.from_numpy(b["images"]).to(d),
            torch.from_numpy(b["labels"]).to(d),
            torch.from_numpy(np.broadcast_to(cands[None], (e,) + cands.shape)
                             .copy()).to(d)).cpu()
        launched = (nms_cuda.launches - before[0],
                    fused_filter.launches - before[1])
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
