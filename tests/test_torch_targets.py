"""The port's training samplers (lang2seg_tpu_torch.ops.targets) and its
per-expression proposal extents against the JAX package, given the same
random draws.

The JAX samplers draw from a key: anchor_targets splits it into (k_pos,
k_neg) and draws one uniform per anchor from each; proposal_targets
splits it into (k_fg, k_bg, k_rep), draws one uniform per candidate from
the first two and randint(k_rep, 0, bg_count) for the with-replacement bg
branch. The tests run that chain and hand its numbers to the port (the
randint as the uniform whose floor(u * bg_count) is the same integer).
Labels, selected rois, flags and mask targets must be identical; box
targets agree to 2 f32 ulps (exp / log differ by an ulp between XLA's
and PyTorch's CPU math)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from lang2seg_tpu.ops.anchors import shifted_anchors as jshifted_anchors
from lang2seg_tpu.ops.proposals import proposal_layer as jproposal_layer
from lang2seg_tpu.ops.targets import anchor_targets as janchor_targets
from lang2seg_tpu.ops.targets import proposal_targets as jproposal_targets
from lang2seg_tpu_torch.ops.anchors import shifted_anchors
from lang2seg_tpu_torch.ops.boxes import box_iou
from lang2seg_tpu_torch.ops.proposals import proposal_layer
from lang2seg_tpu_torch.ops.targets import anchor_targets, proposal_targets

H, W = 128, 192                 # the tiny canvas; 8 x 12 feature map
SCALES, RATIOS = (4, 8, 16, 32), (0.5, 1.0, 2.0)


def _box(x1, y1, bw, bh, cls=3.0):
    return [x1, y1, x1 + bw, y1 + bh, cls]


def _jitter(rng, box, n, amp):
    b = np.asarray(box[:4], np.float32)
    return (b + rng.uniform(-amp, amp, (n, 4))).astype(np.float32)


def _far(rng, n, x0, y0, x1, y1, size=12.0):
    xy = np.stack([rng.uniform(x0, x1 - size, n),
                   rng.uniform(y0, y1 - size, n)], 1)
    wh = rng.uniform(4.0, size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_anchor_targets_match_jax(rng):
    anchors = np.asarray(jshifted_anchors(H // 16, W // 16, 16, SCALES,
                                          RATIOS))
    n = anchors.shape[0]
    gt = np.asarray([[_box(20, 10, 90, 80), _box(100, 40, 60, 70, 7)],
                     [_box(5, 5, 40, 30, 2), _box(60, 30, 100, 90, 9)],
                     [_box(30, 20, 120, 95, 5), _box(0, 0, 10, 10, 1)]],
                    np.float32)
    gt_valid = np.asarray([[True, True], [True, False], [True, True]])
    im_hw = np.asarray([[128, 192], [100, 150], [90, 170]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    # a small budget and a lower positive overlap, so that the positives
    # and negatives of expression 0 outnumber their budgets and the
    # subsampling decides
    kw = dict(rpn_batchsize=8, fg_fraction=0.5, pos_overlap=0.5)
    for clobber in (False, True):
        want, draws = [], []
        for e in range(3):
            k_pos, k_neg = jax.random.split(keys[e])
            draws.append((np.asarray(jax.random.uniform(k_pos, (n,))),
                          np.asarray(jax.random.uniform(k_neg, (n,)))))
            want.append(janchor_targets(
                jnp.asarray(anchors), jnp.asarray(gt[e]),
                jnp.asarray(gt_valid[e]), im_hw[e, 0], im_hw[e, 1], keys[e],
                clobber_positives=clobber, **kw))
        got = anchor_targets(
            torch.from_numpy(anchors), torch.from_numpy(gt),
            torch.from_numpy(gt_valid), torch.from_numpy(im_hw[:, 0]),
            torch.from_numpy(im_hw[:, 1]),
            draws=[torch.from_numpy(np.stack(d)) for d in zip(*draws)],
            clobber_positives=clobber, **kw)
        for e in range(3):
            w = want[e]
            labels = got.labels[e].numpy()
            np.testing.assert_array_equal(labels, np.asarray(w.labels))
            if e == 0:
                assert (labels == 1).sum() == 4 and (labels == 0).sum() == 4
            np.testing.assert_array_max_ulp(got.bbox_targets[e].numpy(),
                                            np.asarray(w.bbox_targets), 2)
            np.testing.assert_array_equal(got.bbox_inside_w[e].numpy(),
                                          np.asarray(w.bbox_inside_w))
            np.testing.assert_array_equal(got.bbox_outside_w[e].numpy(),
                                          np.asarray(w.bbox_outside_w))


def _proposal_case(rng):
    """Four expressions, one per branch of the ROI sampler: (0) fg and
    bg proposals; (1) 3 bg candidates for 24 bg slots (with replacement);
    (2) no proposal reaches fg_thresh (the GT boxes become the fg); (3) no
    bg candidate at all (every slot fg, cycling), some rois invalid."""
    p, m = 128, 2
    g0 = _box(30, 20, 80, 70, 4)
    gt = np.asarray([[g0, _box(120, 40, 50, 60, 11)],
                     [g0, _box(0, 0, 1, 1, 1)],
                     [g0, _box(110, 50, 60, 50, 6)],
                     [g0, _box(120, 40, 50, 60, 11)]], np.float32)
    gt_valid = np.asarray([[True, True], [True, False], [True, False],
                           [True, True]])
    rois = np.stack([
        np.concatenate([_jitter(rng, g0, 48, 20.0),
                        _far(rng, 80, 0, 0, W, H, 40.0)]),
        np.concatenate([_jitter(rng, g0, 125, 3.0),
                        _far(rng, 3, 150, 100, W, H)]),
        _far(rng, 128, 130, 0, W, 20),
        _jitter(rng, g0, 128, 2.0)])
    roi_valid = np.ones((4, p), bool)
    roi_valid[3, ::5] = False
    masks = (rng.uniform(size=(4, m, H, W)) > 0.5).astype(np.uint8)
    return rois, roi_valid, gt, gt_valid, masks


def _bg_count(rois, roi_valid, gt, gt_valid, bg_hi=0.5, bg_lo=0.0):
    cand = torch.from_numpy(np.concatenate([rois, gt[:, :4]]))
    iou = box_iou(cand, torch.from_numpy(gt[:, :4]))
    iou = torch.where(torch.from_numpy(gt_valid)[None], iou, -1.0)
    mx = iou.amax(1)
    valid = torch.from_numpy(np.concatenate([roi_valid, gt_valid]))
    is_gt = torch.arange(cand.shape[0]) >= rois.shape[0]
    return int((valid & (mx < bg_hi) & (mx >= bg_lo) & ~is_gt).sum())


def test_proposal_targets_match_jax(rng):
    rois, roi_valid, gt, gt_valid, masks = _proposal_case(rng)
    e, p = rois.shape[:2]
    m = gt.shape[1]
    kw = dict(num_rois=32, fg_fraction=0.25, mask_size=14)
    keys = jax.random.split(jax.random.PRNGKey(9), e)
    want, draws = [], []
    for i in range(e):
        want.append(jproposal_targets(
            jnp.asarray(rois[i]), jnp.asarray(roi_valid[i]),
            jnp.asarray(gt[i]), jnp.asarray(gt_valid[i]),
            jnp.asarray(masks[i]), keys[i], **kw))
        k_fg, k_bg, k_rep = jax.random.split(keys[i], 3)
        safe_bg = max(_bg_count(rois[i], roi_valid[i], gt[i], gt_valid[i]),
                      1)
        rep = np.asarray(jax.random.randint(k_rep, (32,), 0, safe_bg))
        draws.append((np.asarray(jax.random.uniform(k_fg, (p + m,))),
                      np.asarray(jax.random.uniform(k_bg, (p + m,))),
                      ((rep + 0.5) / safe_bg).astype(np.float32)))
    got = proposal_targets(
        torch.from_numpy(rois), torch.from_numpy(roi_valid),
        torch.from_numpy(gt), torch.from_numpy(gt_valid),
        torch.from_numpy(masks),
        draws=[torch.from_numpy(np.stack(d)) for d in zip(*draws)], **kw)
    for i in range(e):
        w = want[i]
        for name in ("rois", "labels", "roi_valid", "bbox_weight",
                     "mask_targets", "mask_weight"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(w, name)),
                                          err_msg=f"expression {i}: {name}")
        np.testing.assert_array_max_ulp(got.bbox_targets[i].numpy(),
                                        np.asarray(w.bbox_targets), 2)
    labels = got.labels.numpy()
    # each expression ran the branch it was built for
    assert (labels[0, :8] > 0).all() and (labels[0, 8:] == 0).all()
    bg_rois = got.rois[1, 8:].numpy()
    assert len(np.unique(bg_rois, axis=0)) <= 3       # with replacement
    np.testing.assert_array_equal(got.rois[2, 0].numpy(), gt[2, 0, :4])
    assert (labels[2, 1:] == 0).all() and labels[2, 0] == 4
    assert (labels[3] == 4).all() and (got.roi_valid[3].numpy()).all()


def test_proposal_layer_per_expression_extents(rng):
    """A training batch clips each expression's boxes to its own image:
    (E,) extents against the JAX layer run per expression."""
    fh, fw = H // 16, W // 16
    anchors = np.asarray(jshifted_anchors(fh, fw, 16, SCALES, RATIOS))
    n = anchors.shape[0]
    e = 3
    scores = rng.uniform(size=(e, n)).astype(np.float32)
    deltas = (rng.randn(e, n, 4) * 0.3).astype(np.float32)
    im_hw = np.asarray([[128, 192], [77, 140], [100, 61]], np.float32)
    got = proposal_layer(torch.from_numpy(scores), torch.from_numpy(deltas),
                         torch.from_numpy(anchors),
                         torch.from_numpy(im_hw[:, 0]),
                         torch.from_numpy(im_hw[:, 1]), 512, 128, 0.7)
    assert torch.equal(shifted_anchors(fh, fw, 16, SCALES, RATIOS),
                       torch.from_numpy(anchors))
    for i in range(e):
        want = jproposal_layer(jnp.asarray(scores[i]), jnp.asarray(deltas[i]),
                               jnp.asarray(anchors), im_hw[i, 0],
                               im_hw[i, 1], 512, 128, 0.7, nms_impl="xla")
        np.testing.assert_array_equal(got.valid[i].numpy(),
                                      np.asarray(want.valid))
        # decoded corners carry exp's ulp times the anchor extent, as in
        # tests/test_torch_slice.py::test_proposals_on_jax_rpn_outputs
        np.testing.assert_allclose(got.rois[i].numpy(), np.asarray(want.rois),
                                   rtol=1e-6, atol=1e-4)
        assert got.rois[i, :, 2].max() <= im_hw[i, 1] - 1.0
        assert got.rois[i, :, 3].max() <= im_hw[i, 0] - 1.0
