"""Box math, anchors, ROI crop and the proposal layer of the PyTorch port
(lang2seg_tpu_torch.ops) against their JAX counterparts, on the same
seeded numpy inputs. IoU, clipping and anchors are elementwise f32 in the
same operation order, so they must agree bit for bit; encode / decode
differ only through exp / log (an ulp); the crop is two contractions
summed in another order, held at 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lang2seg_tpu.ops import anchors as janchors
from lang2seg_tpu.ops import boxes as jboxes
from lang2seg_tpu.ops.proposals import proposal_layer as jproposal_layer
from lang2seg_tpu.ops.roi_align import crop_and_resize as jcrop
from lang2seg_tpu.ops.roi_align import roi_crop_pool as jroi_crop_pool
from lang2seg_tpu_torch.ops import anchors as panchors
from lang2seg_tpu_torch.ops import boxes as pboxes
from lang2seg_tpu_torch.ops.proposals import proposal_layer
from lang2seg_tpu_torch.ops.roi_align import crop_and_resize, roi_crop_pool


def rand_boxes(rng, n, lim=100.0):
    xy = rng.uniform(0, lim, (n, 2))
    wh = rng.uniform(5, lim / 2, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_box_math_bit_identical(rng):
    a = rand_boxes(rng, 64)
    b = rand_boxes(rng, 48)
    np.testing.assert_array_equal(
        pboxes.box_iou(T(a), T(b)).numpy(),
        np.asarray(jboxes.box_iou(jnp.asarray(a), jnp.asarray(b))))
    # encode / decode go through log / exp, whose CPU implementations in
    # XLA and in PyTorch differ by up to an ulp: held at 2 f32 ulps
    # relative, far below anything the +1-pixel convention can see
    gt = rand_boxes(rng, 64)
    np.testing.assert_allclose(
        pboxes.encode_boxes(T(a), T(gt)).numpy(),
        np.asarray(jboxes.encode_boxes(jnp.asarray(a), jnp.asarray(gt))),
        rtol=2.5e-7, atol=2.5e-7)
    # deltas beyond the dw/dh clamp at 10, class-grouped (N, K*4)
    deltas = (rng.randn(64, 12) * 4.0).astype(np.float32)
    deltas[:4, 2] = 50.0
    want = np.asarray(jboxes.decode_boxes(jnp.asarray(a),
                                          jnp.asarray(deltas)))
    got = pboxes.decode_boxes(T(a), T(deltas)).numpy()
    # a corner is center -/+ half-extent: the exp ulp of a 1e5-px extent
    # shows as an absolute error on a small corner
    np.testing.assert_allclose(got, want, rtol=2.5e-7,
                               atol=2.5e-7 * float(np.abs(want).max()))
    assert np.isfinite(got).all()
    clipped = pboxes.clip_boxes(T(got), 90.0, 110.0).numpy()
    np.testing.assert_array_equal(
        clipped, np.asarray(jboxes.clip_boxes(jnp.asarray(got), 90.0, 110.0)))


def test_decode_batched_over_expressions(rng):
    """(E, N, 4) deltas against shared (N, 4) anchors, as the proposal
    layer calls it, equal the per-expression decode."""
    anchors = rand_boxes(rng, 32)
    deltas = (rng.randn(3, 32, 4) * 0.5).astype(np.float32)
    got = pboxes.decode_boxes(T(anchors), T(deltas)).numpy()
    for e in range(3):
        np.testing.assert_array_equal(
            got[e], pboxes.decode_boxes(T(anchors), T(deltas[e])).numpy())


def test_anchors_identical():
    np.testing.assert_array_equal(
        panchors.generate_base_anchors(16, (0.5, 1.0, 2.0), (4, 8, 16, 32)),
        janchors.generate_base_anchors(16, (0.5, 1.0, 2.0), (4, 8, 16, 32)))
    got = panchors.shifted_anchors(8, 12, 16, (4, 8, 16, 32),
                                   (0.5, 1.0, 2.0)).numpy()
    want = np.asarray(janchors.shifted_anchors(8, 12, 16, (4, 8, 16, 32),
                                               (0.5, 1.0, 2.0)))
    assert got.shape == (8 * 12 * 12, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_pool", [False, True])
def test_roi_crop_matches_jax(rng, max_pool):
    e, h, w, c = 2, 8, 12, 16
    feat = rng.randn(e, h, w, c).astype(np.float32)
    rois = np.stack([rand_boxes(rng, 5, lim=150.0) for _ in range(e)])
    rois[0, 0] = [-20.0, -10.0, 250.0, 140.0]      # reaches off the map
    got = roi_crop_pool(T(feat), T(rois), 7, 1.0 / 16, max_pool).numpy()
    for i in range(e):
        want = np.asarray(jroi_crop_pool(jnp.asarray(feat[i]),
                                         jnp.asarray(rois[i]), 7, 1.0 / 16,
                                         max_pool))
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-4)
    assert crop_and_resize(T(feat), T(rois), 7, 1.0 / 16).shape == \
        (e, 5, 7, 7, c)
    np.testing.assert_allclose(
        crop_and_resize(T(feat[:1]), T(rois[:1]), 7, 1.0 / 16).numpy()[0],
        np.asarray(jcrop(jnp.asarray(feat[0]), jnp.asarray(rois[0]), 7,
                         1.0 / 16)), rtol=1e-4, atol=1e-4)


def test_proposal_layer_keep_sets_match_jax(rng):
    """Same scores and deltas -> the same kept proposals in the same
    order, per expression, with the padded slots holding the top box."""
    fh, fw = 8, 12
    anchors = janchors._shifted_anchors_np(fh, fw, 16, (4, 8, 16, 32),
                                           (0.5, 1.0, 2.0))
    n = anchors.shape[0]
    e = 3
    scores = rng.uniform(0, 1, (e, n)).astype(np.float32)
    scores[0, 10:20] = scores[0, 5]                 # ties: index order
    deltas = (rng.randn(e, n, 4) * 0.3).astype(np.float32)
    im_h, im_w = 120.0, 180.0
    got = proposal_layer(T(scores), T(deltas), T(anchors),
                         torch.tensor(im_h), torch.tensor(im_w), 256, 32, 0.7)
    for i in range(e):
        want = jproposal_layer(jnp.asarray(scores[i]), jnp.asarray(deltas[i]),
                               jnp.asarray(anchors), jnp.float32(im_h),
                               jnp.float32(im_w), 256, 32, 0.7,
                               nms_impl="xla")
        wv = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid[i].numpy(), wv)
        np.testing.assert_allclose(got.rois[i].numpy(), np.asarray(want.rois),
                                   rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(got.scores[i].numpy(),
                                      np.asarray(want.scores))
    # a small post count leaves no padding; a large one pads with box 0
    big = proposal_layer(T(scores[:1]), T(deltas[:1]), T(anchors), im_h,
                         im_w, 256, 256, 0.3)
    pad = ~big.valid[0]
    assert pad.any()
    np.testing.assert_array_equal(
        big.rois[0][pad].numpy(),
        np.broadcast_to(big.rois[0, 0].numpy(), (int(pad.sum()), 4)))
