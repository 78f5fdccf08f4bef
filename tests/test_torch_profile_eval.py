"""`tools/profile_eval.py`'s eval mix on the CPU at the tiny config: its
batches keep the loader's contract (the rounded pixel means beyond the
integer scaled extent, masks inside it), so the extent crop scores as the
full canvas bit for bit and two images a dispatch as one; and the mode
checks it runs on the card catch a wrong mode."""

import copy

import numpy as np
import pytest
import torch

from lang2seg_tpu_torch.engine.evaluator import Evaluator
from lang2seg_tpu_torch.tools import profile_eval
from lang2seg_tpu_torch.utils.metrics import SegEvalAccumulator
from tests.test_torch_weights import (response_config, shared_weights,
                                      to_port_cfg)


@pytest.fixture(scope="module")
def mix():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = to_port_cfg(response_config())
    cfg.data.max_orig_h, cfg.data.max_orig_w = 128, 192
    cfg.data.wire_extent_granularity = 32
    model = shared_weights(response_config(), seed=2,
                           scale_rpn_cls=100.0)[0]
    yield cfg, model, profile_eval.eval_mix(cfg, repeats=1)
    torch.set_num_threads(n)


def test_mix_batches_follow_the_loader_contract(mix):
    cfg, _, batches = mix
    means = np.round(np.asarray(cfg.data.pixel_means_bgr)).astype(np.uint8)
    assert [int(b["sent_valid"].sum()) for b in batches] == \
        list(profile_eval.REAL_COUNTS)
    assert [b["labels"].shape[0] for b in batches] == [4, 8, 16, 16, 8, 8,
                                                       16, 4]
    for b in batches:
        sh, sw = (int(v) for v in b["im_hw"][0])
        assert np.array_equal(b["im_hw"][0], [sh, sw])
        assert (b["images"][0, sh:] == means).all()
        assert (b["images"][0, :, sw:] == means).all()
        assert not b["gt_mask_bank"][:, sh:].any()
        assert not b["gt_mask_bank"][:, :, sw:].any()
        rows = b["gt_mask_bank"].shape[0]
        assert rows in (b["labels"].shape[0] // 2, b["labels"].shape[0])
        assert b["mask_ref_idx"].max() < rows


def _state(model, cfg, batches, k, crop):
    cfg = copy.deepcopy(cfg)
    cfg.data.wire_extent_crop = crop
    acc = SegEvalAccumulator()
    Evaluator(model, cfg, device="cpu").eval_split(
        batches, images_per_dispatch=k, acc=acc)
    return profile_eval._state(acc)


def test_mix_scores_alike_in_every_mode(mix):
    """One and two images a dispatch, the crop on (granularity 32) and
    off: the crop leaves the state bit for bit, two images a dispatch
    scores the det_correct and seg_correct of one (bit for bit here)."""
    cfg, model, batches = mix
    states = {(k, crop): _state(model, cfg, batches, k, crop)
              for k in (1, 2) for crop in (True, False)}
    assert states[(1, True)] == states[(1, False)]
    assert states[(2, True)] == states[(2, False)]
    assert states[(2, False)] == states[(1, False)]
    assert states[(1, False)][0] == sum(profile_eval.REAL_COUNTS)


def test_check_modes_names_each_fault():
    """Faults in the counts, in one sentence (a missing one, a U off by
    more than 4, a box off by more than f32 rounding), between the crop
    on and off, in the launches and host syncs are each named; gaps
    within the tolerances are not."""
    good_sent = {"0:0": ([1.0, 2.0, 30.0, 40.0], 10, 20),
                 "0:1": ([5.0, 6.0, 70.0, 80.0], 0, 30)}

    def mode(k, crop, staged, state, dispatches=((1, 4, 1, 1, 0.5),),
             syncs=(), sentences=good_sent):
        return {"mode": {"images_per_dispatch": k, "extent_crop": crop,
                         "staged": staged},
                "state": state, "sentences": dict(sentences),
                "dispatches": list(dispatches),
                "launches": (len(dispatches),) * 2,
                "host_syncs": list(syncs)}

    good = (2, 0, 10, 50, (0, 0, 0, 0, 0), 2)
    res = {profile_eval.mode_name(k, c, s): mode(k, c, s, good)
           for k, c, s in profile_eval.MODES}
    assert profile_eval.check_modes(res) == []
    edge = {"0:0": ([1.0 + 5e-3, 2.0, 30.0, 40.0], 10, 24),
            "0:1": good_sent["0:1"]}
    res["ipd4_cropon_stagedoff"] = mode(4, True, False, good,
                                        sentences=edge)
    res["ipd4_cropoff_stagedoff"] = mode(4, False, False, good,
                                         dispatches=((4, 16, 1, 2, 3.0),),
                                         sentences=edge)
    res["ipd4_cropon_stagedon"] = mode(4, True, True,
                                       good[:2] + (11,) + good[3:])
    res["ipd4_cropoff_stagedon"] = mode(
        4, False, True, good,
        sentences={"0:0": good_sent["0:0"],
                   "0:1": ([5.0, 6.0, 70.0, 80.0], 0, 35)})
    res["ipd1_cropon_stagedon"] = mode(
        1, True, True, good, sentences={"0:0": good_sent["0:0"]})
    res["ipd1_cropoff_stagedoff"] = mode(
        1, False, False, good,
        sentences={"0:0": ([1.0, 2.0, 30.05, 40.0], 10, 20),
                   "0:1": good_sent["0:1"]})
    res["ipd1_cropon_stagedoff"] = mode(1, True, False, good,
                                        syncs=("a sync",))
    wrong = profile_eval.check_modes(res)
    assert sorted({w.split(":")[0] for w in wrong}) == [
        "ipd1_cropoff_stagedoff", "ipd1_cropon_stagedoff",
        "ipd1_cropon_stagedon", "ipd4_cropoff_stagedoff",
        "ipd4_cropoff_stagedon", "ipd4_cropon_stagedon"]
    assert res["ipd4_cropon_stagedoff"]["sentence_gaps"] == {
        "box_px": pytest.approx(5e-3), "inter": 0, "union": 4,
        "boxes_moved": 1}
