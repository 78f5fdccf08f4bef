"""Comprehension accuracy of the port (`engine/comprehension.py`) against
the JAX package's, at the tiny `response` config (resnet26, 128x192, f32)
on a mini REFER split built in memory: each candidate box's score within
1e-5, and the same hits and counts over GT boxes (`eval_split`) and over a
dets file (`eval_split_dets`, with images that have no detections);
`DetsLoader` in both file formats; a uint8 canvas scored as its
mean-subtracted f32 copy (the JAX scorer feeds it raw).

Both packages score the f32 canvas, where they agree on what the backbone
sees."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lang2seg_tpu.engine.comprehension import (
    ComprehensionEvaluator as JComprehensionEvaluator,
    DetsLoader as JDetsLoader)
from lang2seg_tpu_torch.data.fixtures import mini_refer_split
from lang2seg_tpu_torch.data.loader import GtBatchLoader
from lang2seg_tpu_torch.engine.comprehension import (ComprehensionEvaluator,
                                                     DetsLoader)
from tests.test_torch_weights import (response_config, shared_weights,
                                      to_port_cfg)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def comp_setup():
    """Shared weights, the test batches of a mini REFER split (f32
    canvases, sentence buckets 4 / 8 / 16) and both evaluators."""
    cfg = response_config(word_drop_out=0.0)
    cfg.data.wire_uint8_images = False
    info, labels, read = mini_refer_split(
        ((120, 160), (160, 120), (96, 128), (128, 96), (120, 160)),
        (3, 2, 4, 1, 3), ("val",) * 5, seed=1)
    cfg.model.vocab_size = len(info["word_to_ix"])
    model, jmodel, params = shared_weights(cfg, seed=2)
    loader = GtBatchLoader(info, labels, to_port_cfg(cfg), seed=0,
                           read_image=read)
    batches = list(loader.iter_test_batches("val", buckets=(4, 8, 16)))
    ev = ComprehensionEvaluator(model, to_port_cfg(cfg), device="cpu")
    jev = JComprehensionEvaluator(jmodel, cfg)
    return cfg, ev, jev, params, batches


def test_box_scores_match_jax(comp_setup):
    """score_boxes (E, B) within 1e-5 on every image of the split, its GT
    boxes and two boxes besides as candidates."""
    cfg, ev, jev, params, batches = comp_setup
    for b in batches:
        e = b["labels"].shape[0]
        cands = np.concatenate([b["gt_boxes"][b["sent_valid"], :4],
                                [[2.0, 3.0, 40.0, 50.0],
                                 [30.0, 10.0, 100.0, 90.0]]]).astype(
            np.float32)
        boxes = np.broadcast_to(cands[None], (e,) + cands.shape)
        with jax.default_matmul_precision("float32"):
            want = np.asarray(jev._score(params, {
                "images": jnp.asarray(b["images"]),
                "labels": jnp.asarray(b["labels"])}, jnp.asarray(boxes)))
        got = ev.score_boxes(torch.from_numpy(b["images"]),
                             torch.from_numpy(b["labels"]),
                             torch.from_numpy(boxes.copy())).numpy()
        assert got.shape == want.shape == (e, len(cands))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_eval_split_matches_jax(comp_setup):
    """Over GT boxes: the same hits and n, image by image and over the
    split; n counts the valid sentences."""
    cfg, ev, jev, params, batches = comp_setup
    for b in batches:
        cands = np.unique(b["gt_boxes"][b["sent_valid"], :4], axis=0)
        with jax.default_matmul_precision("float32"):
            want = jev.eval_image(params, b, cands, b["gt_boxes"][:, :4],
                                  b["sent_valid"])
        got = ev.eval_image(b, cands, b["gt_boxes"][:, :4], b["sent_valid"])
        assert got == want
    with jax.default_matmul_precision("float32"):
        want = jev.eval_split(params, batches)
    got = ev.eval_split(batches)
    assert got == want
    assert got["n"] == sum(int(b["sent_valid"].sum()) for b in batches)
    assert 0 < got["comprehension_acc"] < 1


@pytest.mark.parametrize("fmt", ["flat", "keyed"])
def test_eval_split_dets_matches_jax(comp_setup, tmp_path, fmt):
    """Over detections: a dets file with each image's GT boxes jittered
    and a few random boxes, but none for two images; the same hits, n and
    skipped_no_dets, max_cands 6 cutting the longer lists."""
    cfg, ev, jev, params, batches = comp_setup
    r = np.random.RandomState(3)
    dets, keyed, det_id = [], {}, 1
    for bi, b in enumerate(batches):
        if bi in (1, 3):
            continue
        gt = b["gt_boxes"][b["sent_valid"], :4] / b["im_scale"]
        extra = np.stack([r.uniform(0, 40, 5), r.uniform(0, 40, 5),
                          r.uniform(60, 110, 5), r.uniform(60, 110, 5)], 1)
        for box in np.concatenate([gt + r.randn(*gt.shape) * 2.0, extra]):
            x1, y1, x2, y2 = (float(v) for v in box)
            dets.append({"det_id": det_id, "box": [x1, y1, x2 - x1 + 1,
                                                   y2 - y1 + 1],
                         "image_id": int(b["image_id"]), "category_id": 1,
                         "category_name": "person",
                         "score": float(r.uniform(0.1, 1.0))})
            keyed.setdefault(str(b["image_id"]), []).append(
                {"box": [x1, y1, x2, y2], "score": dets[-1]["score"]})
            det_id += 1
    path = tmp_path / "dets.json"
    path.write_text(json.dumps({"dets": dets} if fmt == "flat" else keyed))
    dl, jdl = DetsLoader(str(path)), JDetsLoader(str(path))
    for b in batches:
        for s in (1.0, float(b["im_scale"])):
            np.testing.assert_array_equal(
                dl.candidates(int(b["image_id"]), s, 0.3),
                jdl.candidates(int(b["image_id"]), s, 0.3))
    with jax.default_matmul_precision("float32"):
        want = jev.eval_split_dets(params, batches, jdl, max_cands=6)
    got = ev.eval_split_dets(batches, dl, max_cands=6)
    assert got == want
    skipped = sum(int(batches[i]["sent_valid"].sum()) for i in (1, 3))
    assert got["skipped_no_dets"] == skipped
    assert got["n"] == sum(int(b["sent_valid"].sum())
                           for b in batches) - skipped


def test_dets_loader_formats_match_jax(tmp_path):
    """The reference's flat xywh format (x + w - 1) and the image-keyed
    xyxy format: the same candidates and Dets tables as the JAX loader."""
    flat = {"dets": [
        {"det_id": 1, "box": [10, 20, 30, 40], "image_id": 100,
         "category_id": 1, "category_name": "person", "score": 0.9},
        {"det_id": 2, "box": [5, 5, 10, 10], "image_id": 100,
         "category_id": 18, "category_name": "dog", "score": 0.2},
        {"det_id": 3, "box": [0, 0, 50, 60], "image_id": 101,
         "category_id": 1, "category_name": "person", "score": 0.7}]}
    keyed = {"100": [{"box": [1, 2, 3, 4], "score": 1.0},
                     {"box": [2, 2, 9, 9]}]}
    for obj in (flat, keyed):
        p = tmp_path / "dets.json"
        p.write_text(json.dumps(obj))
        dl, jdl = DetsLoader(str(p)), JDetsLoader(str(p))
        assert dl.dets == jdl.dets and dl.Dets == jdl.Dets
        for args in ((100,), (100, 2.0, 0.5), (101, 1.5), (999,)):
            got, want = dl.candidates(*args), jdl.candidates(*args)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(DetsLoader(str(p)).candidates(100),
                                  [[1, 2, 3, 4], [2, 2, 9, 9]])


def test_uint8_canvas_scores_as_f32(comp_setup):
    """The port subtracts the means from a uint8 canvas on the device:
    the same scores as the f32 canvas (within 1e-5). The JAX scorer feeds
    the uint8 canvas to the backbone as it is, and scores otherwise."""
    cfg, ev, jev, params, batches = comp_setup
    b = batches[0]
    means = np.asarray(cfg.data.pixel_means_bgr, np.float32)
    u8 = np.clip(np.round(b["images"] + means), 0, 255).astype(np.uint8)
    f32 = u8.astype(np.float32) - means
    cands = b["gt_boxes"][b["sent_valid"], :4]
    e = b["labels"].shape[0]
    boxes = torch.from_numpy(np.broadcast_to(
        cands[None], (e,) + cands.shape).copy())
    labels = torch.from_numpy(b["labels"])
    got_u8 = ev.score_boxes(torch.from_numpy(u8), labels, boxes).numpy()
    got_f32 = ev.score_boxes(torch.from_numpy(f32), labels, boxes).numpy()
    np.testing.assert_allclose(got_u8, got_f32, rtol=0, atol=1e-5)
    with jax.default_matmul_precision("float32"):
        jax_u8 = np.asarray(jev._score(params, {
            "images": jnp.asarray(u8), "labels": jnp.asarray(b["labels"])},
            jnp.asarray(boxes.numpy())))
    assert np.abs(jax_u8 - got_f32).max() > 1e-3


def test_evaluator_refuses_missing_card(comp_setup, monkeypatch):
    cfg, ev, _, _, _ = comp_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ComprehensionEvaluator(ev.model, ev.cfg)
