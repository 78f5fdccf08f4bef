"""The reference-exact metric chain of the port against the JAX package's,
bit for bit: `bytescale`, `scipy_imresize` (the port's NumPy copies of
Pillow's 'L'-mode NEAREST and BILINEAR resizes against the JAX function,
which calls Pillow) over a sweep of sizes, `recover_masks_ref`, and the
loader's `reference_exact_masks` batches; the port needs no Pillow."""

import itertools
import os
import sys

import numpy as np
import pytest

from lang2seg_tpu.config import Config
from lang2seg_tpu.data.fixtures import make_mini_refer
from lang2seg_tpu.data.loader import GtBatchLoader as JGtBatchLoader
from lang2seg_tpu.data.prepro import run_prepro
from lang2seg_tpu.utils import metrics as jmetrics
from lang2seg_tpu_torch.data.loader import GtBatchLoader
from lang2seg_tpu_torch.utils import metrics
from tests.test_torch_weights import to_port_cfg

# output extents: 1-pixel edges, the 14x14 mask's own size, box sizes and
# canvas-scale extents
SIZES = (1, 2, 3, 7, 13, 14, 15, 27, 64, 101, 255, 427, 640)


@pytest.mark.parametrize("data", [
    np.array([[0, 7], [255, 130]], np.uint8),
    np.array([0.3, 0.375, 0.45], np.float32),
    np.full((3, 3), 0.7, np.float32),
    np.linspace(-2.0, 5.0, 60, dtype=np.float64).reshape(6, 10),
])
def test_bytescale_matches_jax(data):
    """uint8 passes through (the same object), any other dtype is rescaled
    by its own min / max and rounded half up; a constant array is 0."""
    got, want = metrics.bytescale(data), jmetrics.bytescale(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if data.dtype == np.uint8:
        assert got is data


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_scipy_imresize_bit_identical_to_pillow(interp, rng):
    """The port's Pillow copies through scipy_imresize against the JAX
    scipy_imresize (Pillow 'L' mode) on uint8 noise: upscaling 14 -> box
    sizes, downscaling (BILINEAR's widened support), aspect changes and
    1-pixel sources and targets; and on float masks through bytescale."""
    cases = 0
    for h, w in itertools.product((1, 2, 14, 37, 480), (1, 3, 14, 53, 640)):
        data = rng.randint(0, 256, (h, w)).astype(np.uint8)
        for oh, ow in zip(rng.choice(SIZES, 6), rng.choice(SIZES, 6)):
            got = metrics.scipy_imresize(data, (oh, ow), interp)
            want = jmetrics.scipy_imresize(data, (oh, ow), interp)
            assert got.dtype == np.uint8 and got.shape == (oh, ow)
            np.testing.assert_array_equal(got, want,
                                          err_msg=str((h, w, oh, ow)))
            cases += 1
    for oh, ow in itertools.product((1, 9, 14, 33, 200), (1, 14, 57, 310)):
        m = rng.rand(14, 14).astype(np.float32) * 255.0
        np.testing.assert_array_equal(
            metrics.scipy_imresize(m, (oh, ow), interp),
            jmetrics.scipy_imresize(m, (oh, ow), interp))
        cases += 1
    assert cases == 170


def test_pil_nearest_is_not_rational_nearest(rng):
    """On binary noise the accumulated source positions of Pillow's
    NEAREST pick other boundary pixels than exact-rational nearest
    (tests/test_ref_exact.py:55): the copy keeps that difference."""
    worst = 0.0
    for _ in range(10):
        h, w = rng.randint(40, 640, 2)
        oh, ow = rng.randint(40, 640, 2)
        m = (rng.rand(h, w) > 0.5).astype(np.uint8)
        pil = metrics.scipy_imresize(m, (oh, ow), "nearest")
        np.testing.assert_array_equal(
            pil, jmetrics.scipy_imresize(m, (oh, ow), "nearest"))
        worst = max(worst, float(
            (pil != metrics.nearest_resize(m, oh, ow)).mean()))
    assert 0.0 < worst < 0.02


def test_recover_masks_ref_matches_jax(rng):
    """The reference-exact paste-back (probabilities x 255 bytescaled, then
    Pillow BILINEAR to the truncated box, painted into a uint8 canvas):
    boxes inside, clipped at every edge, 1-pixel wide, and a constant mask
    (which bytescale makes all zeros)."""
    probs = rng.rand(6, 14, 14).astype(np.float32)
    probs[5] = 0.8
    boxes = np.array([[4.7, 6.2, 13.9, 15.0], [-3.0, 10.0, 40.0, 70.0],
                      [10.0, -5.0, 90.0, 30.5], [30.2, 20.0, 30.9, 44.0],
                      [0.0, 0.0, 63.0, 47.0], [5.0, 5.0, 20.0, 20.0]],
                     np.float32)
    got = metrics.recover_masks_ref(probs, boxes.copy(), 48, 64)
    want = jmetrics.recover_masks_ref(probs, boxes.copy(), 48, 64)
    assert got.dtype == np.uint8 and got.shape == (6, 48, 64)
    np.testing.assert_array_equal(got, want)
    assert got[5].max() == 0 and (got[:5] > 122).any()


def test_port_resizes_without_pillow(monkeypatch, rng):
    """With Pillow made unimportable, the port's chain still runs (the
    JAX package's needs Pillow)."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    probs = rng.rand(1, 14, 14).astype(np.float32)
    out = metrics.recover_masks_ref(probs, np.array([[2.0, 3.0, 30.0, 25.0]]),
                                    32, 32)
    assert out.shape == (1, 32, 32) and (out > 0).any()
    with pytest.raises(ImportError):
        jmetrics.scipy_imresize(probs[0], (20, 20), "nearest")


@pytest.fixture(scope="module")
def mini_refer(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_ref_exact_data"))
    make_mini_refer(root, num_images=3, refs_per_image=2, sents_per_ref=2,
                    img_hw=(60, 80), seed=9)
    jp, hp = run_prepro(root, "refcoco", "unc", os.path.join(root, "prepro"),
                        count_threshold=0)
    return root, jp, hp


@pytest.mark.parametrize("bank", [True, False])
def test_reference_exact_masks_match_jax_loader(mini_refer, bank):
    """cfg.data.reference_exact_masks: the loader's GT masks go through
    Pillow NEAREST (scipy_imresize) onto the canvas. Test batches (with
    and without the ref-deduped bank) and a training batch equal the JAX
    loader's bit for bit, and differ from the default exact-rational
    resize only on a few boundary pixels."""
    root, jp, hp = mini_refer
    cfg = Config()
    cfg.data.image_dir = os.path.join(root, "images", "train2014")
    cfg.data.canvas_h, cfg.data.canvas_w = 128, 192
    cfg.data.wire_mask_bank = bank
    cfg.data.reference_exact_masks = True
    got = GtBatchLoader(jp, hp, to_port_cfg(cfg), seed=7)
    want = JGtBatchLoader(jp, hp, cfg, seed=7)
    key = "gt_mask_bank" if bank else "gt_masks"
    for split in ("train", "val"):
        g, w = got.get_test_batch(split), want.get_test_batch(split)
        np.testing.assert_array_equal(g[key], w[key])
        assert g[key].any()
    g, w = got.get_batch("train"), want.get_batch("train")
    np.testing.assert_array_equal(g["gt_masks"], w["gt_masks"])
    cfg.data.reference_exact_masks = False
    fast = GtBatchLoader(jp, hp, to_port_cfg(cfg), seed=7).get_test_batch(
        "train")[key]
    exact = GtBatchLoader(jp, hp, to_port_cfg(
        dict_set(cfg, reference_exact_masks=True)), seed=7).get_test_batch(
        "train")[key]
    assert exact.shape == fast.shape and (exact != fast).mean() < 0.02


def dict_set(cfg, **data_kw):
    for k, v in data_kw.items():
        setattr(cfg.data, k, v)
    return cfg
