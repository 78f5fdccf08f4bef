"""The port's serving slice against the JAX package's, at the tiny test
config with the `response` variant's conditioning: `Inference.predict`
then `Evaluator.eval_image` of lang2seg_tpu_torch against the same
entry points of lang2seg_tpu, on the same weights and the same seeded
inputs, first stage by stage and then end to end. Also: the port
imports nothing of JAX, and its entry points refuse a missing card.

The shared RPN class weights are scaled by 100 in both packages. At the
flax init (normal 0.01) every anchor's objectness sits within ~1e-3 of
0.5, so the f32 rounding differences of the two frameworks' convolutions
(~1e-6) reorder near-tied anchors in the pre-NMS sort and change which
boxes survive. Scaled logits spread the scores apart; the proposal
layer itself is shown exact on identical scores below."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lang2seg_tpu.engine.evaluator import Evaluator as JaxEvaluator
from lang2seg_tpu.engine.inference import Inference as JaxInference
from lang2seg_tpu.data.synthetic import synthetic_batch
from lang2seg_tpu.ops.anchors import shifted_anchors as jshifted_anchors
from lang2seg_tpu.ops.proposals import proposal_layer as jproposal_layer
from lang2seg_tpu.utils.metrics import SegEvalAccumulator as JaxAccumulator
from lang2seg_tpu_torch.engine.evaluator import Evaluator
from lang2seg_tpu_torch.engine.inference import Inference
from lang2seg_tpu_torch.ops.proposals import proposal_layer
from lang2seg_tpu_torch.utils.metrics import SegEvalAccumulator
from tests.test_torch_weights import response_config, shared_weights

REPO = pathlib.Path(__file__).resolve().parent.parent
RPN_CLS_SCALE = 100.0


@pytest.fixture(scope="module")
def slice_setup():
    cfg = response_config()
    model, jmodel, params = shared_weights(cfg, seed=2,
                                           scale_rpn_cls=RPN_CLS_SCALE)
    return cfg, model, jmodel, params


def _request(cfg, num_expr, seed):
    b = synthetic_batch(cfg, 1, num_expr, seed=seed)
    return {"images": b["images"], "im_hw": b["im_hw"],
            "labels": b["labels"], "gt_boxes": b["gt_boxes"],
            "gt_masks": b["gt_masks"], "im_scale": 1.0}


def test_proposals_on_jax_rpn_outputs(slice_setup):
    """Stage by stage: the JAX model's RPN outputs for a real request go
    through both proposal layers; the kept boxes agree slot for slot."""
    cfg, model, jmodel, params = slice_setup
    b = _request(cfg, 3, seed=11)
    m, ts = cfg.model, cfg.test

    def rpn(mdl, images, labels):
        conv = mdl.backbone.head(images)
        conv = jnp.broadcast_to(conv, (labels.shape[0],) + conv.shape[1:])
        gated, _ = mdl._condition(conv, labels, train=False)
        return mdl.rpn_head(gated)

    with jax.default_matmul_precision("float32"):
        cls, box = jmodel.apply({"params": params}, b["images"], b["labels"],
                                method=rpn)
    e, h, w, a, _ = cls.shape
    n = h * w * a
    scores = np.array(jax.nn.softmax(cls.reshape(e, n, 2), -1)[..., 1])
    deltas = np.array(box).reshape(e, n, 4)
    anchors = np.array(jshifted_anchors(h, w, m.feat_stride,
                                        m.anchor_scales, m.anchor_ratios))
    ih, iw = (float(x) for x in b["im_hw"][0])
    got = proposal_layer(torch.from_numpy(scores), torch.from_numpy(deltas),
                         torch.from_numpy(anchors), torch.tensor(ih),
                         torch.tensor(iw), ts.rpn_pre_nms_top_n,
                         ts.rpn_post_nms_top_n, ts.rpn_nms_thresh)
    for i in range(e):
        want = jproposal_layer(jnp.asarray(scores[i]), jnp.asarray(deltas[i]),
                               jnp.asarray(anchors), jnp.float32(ih),
                               jnp.float32(iw), ts.rpn_pre_nms_top_n,
                               ts.rpn_post_nms_top_n, ts.rpn_nms_thresh,
                               nms_impl="xla")
        np.testing.assert_array_equal(got.valid[i].numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_allclose(got.rois[i].numpy(), np.asarray(want.rois),
                                   rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_predict_matches_jax_inference(slice_setup, wire):
    """Both image wires: a mean-subtracted f32 canvas, and the raw uint8
    BGR canvas whose means both packages subtract on the device."""
    cfg, model, jmodel, params = slice_setup
    b = _request(cfg, 3, seed=7)
    if wire == "uint8":
        means = np.asarray(cfg.data.pixel_means_bgr, np.float32)
        b["images"] = np.clip(np.round(b["images"] + means), 0,
                              255).astype(np.uint8)
    with jax.default_matmul_precision("float32"):
        want = JaxInference(jmodel, params, cfg).predict(
            b["images"], b["im_hw"], b["labels"])
    got = Inference(model, cfg, device="cpu").predict(
        b["images"], b["im_hw"], b["labels"])
    assert set(got) == set(want)
    np.testing.assert_allclose(got["response"].numpy(), want["response"],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["gated_conv"].numpy(), want["gated_conv"],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  want["roi_valid"])
    # the same boxes survive; their corners carry the RPN deltas' ~1e-5
    # framework difference times extents of ~100 px
    np.testing.assert_allclose(got["rois"].numpy(), want["rois"], rtol=1e-4,
                               atol=1e-2)
    for k in ("cls_score", "cls_prob", "bbox_pred"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3,
                                   atol=1e-3, err_msg=k)


@pytest.mark.parametrize("packed", [True, False])
def test_eval_image_matches_jax_evaluator(slice_setup, packed):
    """End to end: det acc, Prec@X and overall IoU from both evaluators.
    The canvas width 192 is a multiple of 8, so masks travel bit-packed;
    a 190-wide crop of the GT masks makes the raw path run too."""
    cfg, model, jmodel, params = slice_setup
    b = _request(cfg, 4, seed=7)         # a draw with ~1000 px of overlap
    if not packed:
        b["gt_masks"] = np.ascontiguousarray(b["gt_masks"][..., :190])
    sent_valid = np.asarray([True, True, False, True])
    jacc = JaxAccumulator()
    with jax.default_matmul_precision("float32"):
        JaxEvaluator(jmodel, cfg).eval_image(params, b, jacc,
                                             sent_valid=sent_valid)
    acc = SegEvalAccumulator()
    Evaluator(model, cfg, device="cpu").eval_image(b, acc,
                                                   sent_valid=sent_valid)
    assert acc.num_sent == jacc.num_sent == 3
    assert acc.det_correct == jacc.det_correct
    np.testing.assert_array_equal(acc.seg_correct, jacc.seg_correct)
    # pixel counts agree up to a few pixels that sit on the 122/255 cut
    assert abs(acc.cum_i - jacc.cum_i) <= 4
    assert abs(acc.cum_u - jacc.cum_u) <= 4
    for k, v in acc.summary().items():
        assert 0.0 <= v <= 1.0, k


def test_paste_iou_matches_host_protocol(rng):
    """The device paste-back (both mask wires) against the host oracle
    recover_masks + nearest_resize + 122/255 cut of utils/metrics.py."""
    from lang2seg_tpu_torch.utils.metrics import nearest_resize, recover_masks
    hc, wc, sh, sw, ih, iw = 96, 128, 90, 120, 60, 80
    probs = rng.uniform(0, 1, (3, 14, 14)).astype(np.float32)
    boxes = np.asarray([[5.3, 4.1, 50.7, 40.2], [0.0, 0.0, 79.0, 59.0],
                        [30.0, 20.0, 90.0, 70.0]], np.float32)
    gt = (rng.uniform(0, 1, (3, hc, wc)) > 0.6).astype(np.uint8)
    want = []
    for i in range(3):
        pred = recover_masks(probs[i:i + 1], boxes[i:i + 1].copy(), ih,
                             iw)[0] * 255.0 > 122.0
        g = nearest_resize(gt[i, :sh, :sw], ih, iw) > 0
        want.append(((pred & g).sum(), (pred | g).sum()))
    for packed in (False, True):
        gm = np.packbits(gt, axis=-1) if packed else gt
        inter, union = Evaluator._paste_iou_fn(
            torch.from_numpy(probs), torch.from_numpy(boxes),
            torch.from_numpy(gm), sh, sw, ih, iw, oh=128, ow=128,
            packed=packed)
        for i in range(3):
            assert abs(int(inter[i]) - want[i][0]) <= 2
            assert abs(int(union[i]) - want[i][1]) <= 2


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted((REPO / "lang2seg_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    names = {f.name for f in files}
    assert {"captioner.py", "caption_zoo.py", "train_captioner.py",
            "loader.py", "tiny_step.py", "vgg.py", "metrics.py", "rle.py",
            "refer.py", "prepro.py", "coco_detection.py", "det_eval.py",
            "make_coco_minus_refer.py", "fixtures.py", "caption_metrics.py",
            "eval_captions.py", "attributes.py", "comprehension.py",
            "matching.py", "mobilenet.py", "visualization.py", "demo.py",
            "roi_pool_cuda.py", "profile_roi_pool.py", "mesh.py"} <= names
    assert (REPO / "lang2seg_tpu_torch" / "parallel" / "train.py") in files
    # the card's machine has no Pillow: the port keeps its own copies of
    # Pillow's resizes (utils/metrics.py)
    banned = ("jax", "jaxlib", "flax", "optax", "lang2seg_tpu", "PIL")
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in banned, f"{f.relative_to(REPO)} imports {name}"


def test_entry_points_refuse_missing_card(monkeypatch, slice_setup):
    from lang2seg_tpu_torch.models.network import build_model
    cfg, model, _, _ = slice_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Inference(model, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        Evaluator(model, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(model.cfg)
