"""The copied eval mix, the bound functions and the FLOP count against
hand counts at small shapes."""

from __future__ import annotations

import json

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, traffic_gen
from benchmark.bounds import crop, nms
from benchmark.bounds.peaks import F32_FLOPS, HBM_BYTES_PER_S

ref = harness.reference_of(harness.config_file(harness.manifest(),
                                               "response"))


def test_eval_mix_is_59_valid_of_80_slots():
    man = harness.manifest()
    cfg = harness.config_file(man, "response")["config"]
    t = harness.traffic_file("eval.mix4")
    mix = traffic_gen.eval_mix(cfg, t, 5)
    assert sum(int(b["sent_valid"].sum()) for b in mix) == 59
    assert sum(b["labels"].shape[0] for b in mix) == 80
    assert [b["labels"].shape[0] for b in mix] == [4, 8, 16, 16, 8, 8, 16, 4]


def test_sub_seeds_take_any_whole_number():
    a = traffic_gen.sub_seed(2 ** 40 + 3, 1, 2)
    assert a == traffic_gen.sub_seed(2 ** 40 + 3, 1, 2)
    assert a != traffic_gen.sub_seed(2 ** 40 + 4, 1, 2)
    assert 0 <= a < 2 ** 32


def test_crop_tap_pixels_by_hand():
    ys = torch.arange(7.0).reshape(1, 1, 7)
    assert crop.tap_pixels(ys, ys, 10, 10, False) == 49
    assert crop.tap_pixels(ys + 0.5, ys, 10, 10, False) == 56
    # off the map to the left: only the columns inside count
    assert crop.tap_pixels(ys, ys - 3.0, 10, 10, False) == 28
    # two expressions on one stride-0 map count it once
    two = torch.cat([ys, ys])
    assert crop.tap_pixels(two, two, 10, 10, True) == 49
    assert crop.tap_pixels(two, two, 10, 10, False) == 98


def test_crop_bounds_by_hand():
    e, r, s, c, h, w = 1, 1, 7, 8, 10, 10
    ys = torch.arange(7.0).reshape(1, 1, 7)
    out = e * r * s * s * c
    byts = 49 * c * 2 + 2 * 7 * 4 + out * 2
    want = max(byts / HBM_BYTES_PER_S, out * 12 / F32_FLOPS)
    assert crop.forward_bound_s((e, h, w, c), 2, False, ys, ys) == want
    byts = out * 2 + 2 * 7 * 4 + h * w * c * 2
    want = max(byts / HBM_BYTES_PER_S, out * 12 / F32_FLOPS)
    assert crop.backward_bound_s((e, r, s, s, c), 2, h, w) == want


def test_nms_bound_by_hand():
    # one lane of 10 boxes, 3 kept (0, 4, 7) before max_out is reached:
    # every box up to the last is tested against each kept box before it
    keep_idx = np.array([[0, 4, 7, 0]])
    keep_mask = np.array([[True, True, True, False]])
    assert nms.pairs(keep_idx, keep_mask, 10, 4) == 9 + 5 + 2
    # max_out reached at box 7: the pass stops there
    assert nms.pairs(keep_idx[:, :3], keep_mask[:, :3], 10, 3) == 7 + 3 + 0
    byts = 10 * 16 + 10 + 4 * 5
    assert nms.bound_s(1, 10, 4, keep_idx, keep_mask) == max(
        byts / HBM_BYTES_PER_S, 16 * 15 / F32_FLOPS)


def test_flops_of_the_rpn_head_by_hand():
    head = ref.RPNHead(64, 12)
    x = torch.zeros((2, 5, 6, 64))
    with FlopCounterMode(display=False) as fc:
        head(x)
    px = 2 * 5 * 6
    assert fc.get_total_flops() == 2 * px * (64 * 9 * 512 + 512 * 24
                                             + 512 * 48)


def test_the_crop_counts_no_flops():
    feat = torch.zeros((2, 8, 9, 16))
    rois = torch.tensor([[[0.0, 0.0, 60.0, 50.0]], [[10.0, 5.0, 90.0, 70.0]]])
    with FlopCounterMode(display=False) as fc:
        a = ref.crop_gather(feat + 1.0, rois, 7, 1 / 16)
    assert fc.get_total_flops() == 0
    b = ref.crop_and_resize(feat + 1.0, rois, 7, 1 / 16)
    assert torch.allclose(a, b, atol=1e-6)


def test_cell_flops_are_the_model_at_its_shapes():
    """The serving count is the backbone head, the RPN, the gate, the
    tail on every crop, the box head and the mask head: at a tiny size,
    against a sum of hand counts of the convolutions and products."""
    from benchmark.flops.count import serve_flops
    from benchmark.tests.tiny import tiny_config
    man = harness.manifest()
    cfg = tiny_config(harness.config_file(man, "response"))["config"]
    total = serve_flops(ref, cfg, 1, 2)
    net = ref.Reference(cfg)
    with FlopCounterMode(display=False) as fc:
        net.resnet.tail(torch.zeros((2 * 32, 7, 7, 1024)))
    tail = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        net.resnet.head(torch.zeros((1, 128, 192, 3)))
    head = fc.get_total_flops()
    assert head + tail < total < head + 1.2 * tail + 2e9
    json.dumps(total)
