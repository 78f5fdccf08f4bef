"""The detection-only `vgg` variant of the port (VGG16, C4 512, a 4096-wide
fc6 / fc7 tail, no mask head) against the JAX package, at the tiny test
size (128x192 canvas, f32 compute; VGG16's depth and widths are fixed):
the backbone's head and tail, the weights bridge with fc6's channel-major
flatten, `test_forward` in test modes 'nms' and 'top', `train_forward`'s
losses and gradients with injected targets, the SGD groups (conv1_* and
conv2_* frozen, double bias, weight decay 5e-4), a reference-format
`vgg16_faster_rcnn` file, the detection-only eval of a split, the
Trainer and the command lines on the CPU, and the fc stack's span and
row counter.

fc6 alone is 411 MB in f32 at any canvas, so the file shares one
module-scoped model. Dropout is off where the packages are compared
(jax.random bits cannot be reproduced in torch): the JAX VGG16 has no
config field for it, so its class is swapped for one with drop_rate 0
while the JAX side runs; the port's tail draws its masks from the step's
generator and is tested on its own."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lang2seg_tpu.models.vgg as jvgg
from benchmark import trace as btrace
from lang2seg_tpu.cli.variants import apply_variant
from lang2seg_tpu.data.fixtures import make_mini_refer
from lang2seg_tpu.data.loader import GtBatchLoader as JGtBatchLoader
from lang2seg_tpu.data.prepro import run_prepro
from lang2seg_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from lang2seg_tpu.engine.convert import convert_torch_state_dict
from lang2seg_tpu.engine.evaluator import Evaluator as JaxEvaluator
from lang2seg_tpu.engine.inference import Inference as JaxInference
from lang2seg_tpu.engine.optimizer import (decay_mask, param_multipliers,
                                           partition_params)
from lang2seg_tpu.engine.train_state import create_model
from lang2seg_tpu.utils.metrics import SegEvalAccumulator as JaxAccumulator
from lang2seg_tpu_torch.cli import eval as cli_eval
from lang2seg_tpu_torch.cli import train as cli_train
from lang2seg_tpu_torch.data.loader import GtBatchLoader
from lang2seg_tpu_torch.data.synthetic import (FixedBatchLoader,
                                              synthetic_batch, to_wire)
from lang2seg_tpu_torch.engine.checkpoint import tolerant_restore
from lang2seg_tpu_torch.engine.convert import load_params_file
from lang2seg_tpu_torch.engine.evaluator import Evaluator
from lang2seg_tpu_torch.engine.inference import Inference
from lang2seg_tpu_torch.engine.optimizer import param_groups
from lang2seg_tpu_torch.engine.train_state import to_device
from lang2seg_tpu_torch.engine.trainer import Trainer
from lang2seg_tpu_torch.models.network import build_model
from lang2seg_tpu_torch.models.vgg import VGG16
from lang2seg_tpu_torch.utils import trace
from lang2seg_tpu_torch.utils.metrics import SegEvalAccumulator
from lang2seg_tpu_torch.weights import from_jax_params, state_dict_shapes
from tests.test_network import tiny_config
from tests.test_torch_train import (_jax_loss_fn, _jax_targets,
                                    _port_grads_as_jax_tree, _rel, _targets)
from tests.test_torch_weights import (_flat, _jax_param_shapes,
                                      shared_weights, to_port_cfg)

LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box",
          "loss_response", "total_loss")


class _JaxVGG16NoDropout(jvgg.VGG16):
    drop_rate: float = 0.0


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def vgg_config():
    """tests/test_network.py::tiny_config under the `vgg` preset (VGG16,
    C4 512, 7 filters, sigmoid gate, response loss, no mask head, weight
    decay 5e-4, double bias), word dropout off, a 64-word vocabulary."""
    cfg = apply_variant(tiny_config(), "vgg")
    cfg.model.word_drop_out = 0.0
    cfg.model.vocab_size = 64
    return cfg


@pytest.fixture(scope="module")
def vgg_setup():
    """One shared VGG model in both packages (the RPN class weights scaled
    by 100, as in tests/test_torch_slice.py), a 2-image x 4-expression
    batch with injected targets, and the JAX losses and gradients on them
    with VGG16's dropout off."""
    cfg = vgg_config()
    cfg.train.learning_rate = 1e-3
    model, jmodel, params = shared_weights(cfg, seed=4, scale_rpn_cls=100.0)
    model.vgg.drop_rate = 0.0
    batch = jsynthetic_batch(cfg, 2, 4, seed=5)
    targets = _targets(cfg, batch, seed=6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision("float32"):
        mp.setattr(jvgg, "VGG16", _JaxVGG16NoDropout)
        (_, j_losses), j_grads = jax.value_and_grad(
            _jax_loss_fn(jmodel, jbatch, _jax_targets(*targets)),
            has_aux=True)(params)
    return (cfg, model, jmodel, params, batch, targets,
            {k: float(v) for k, v in j_losses.items()}, j_grads)


def test_vgg_head_and_tail_match_jax(vgg_setup, rng):
    """VGG16's head (13 convs, 4 pools; stride 16, 512 channels) and its
    eval-mode tail (fc6 on the flattened 7x7 crop, fc7) against the JAX
    VGG16 on the converted weights: within 1e-4 of the max |value|; the
    tail returns (R, 1, 1, 4096) f32."""
    _, model, jmodel, params, *_ = vgg_setup
    images = (rng.randn(2, 64, 96, 3) * 40.0).astype(np.float32)
    crops = rng.randn(5, 7, 7, 512).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want_head = np.asarray(jmodel.apply(
            {"params": params}, images,
            method=lambda m, x: m.backbone.head(x)))
        want_tail = np.asarray(jmodel.apply(
            {"params": params}, crops,
            method=lambda m, x: m.backbone.tail(x)))
    with torch.no_grad():
        got_head = model.vgg.head(torch.from_numpy(images)).numpy()
        got_tail = model.vgg.tail(torch.from_numpy(crops))
    assert got_head.shape == want_head.shape == (2, 4, 6, 512)
    assert got_tail.shape == (5, 1, 1, 4096)
    assert got_tail.dtype == torch.float32
    for got, want in ((got_head, want_head), (got_tail.numpy(), want_tail)):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_vgg_weights_bridge_and_fc6_layout(vgg_setup, rng):
    """The port's `vgg` state_dict maps onto every JAX param with the
    right shapes; from_jax_params inverts convert_torch_state_dict bit for
    bit; and the port's fc6 reads the reference's channel-major flatten:
    for a (512, 7, 7) torch-layout crop, the port's tail equals fc6 as the
    reference applies it (tests/test_convert.py:174's construction), and
    the JAX kernel on the (7, 7, 512) flatten."""
    cfg, model, _, params, *_ = vgg_setup
    got = {k: tuple(np.shape(v)) for k, v in _flat(params).items()}
    assert got == _jax_param_shapes(cfg)
    assert not any("mask_head" in k for k in got)
    back = from_jax_params(params, cfg)
    assert {k: tuple(v.shape) for k, v in back.items()} == \
        state_dict_shapes(to_port_cfg(cfg))
    sd = model.state_dict()
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    pool5 = rng.randn(512, 7, 7).astype(np.float32)          # torch CHW
    w6 = sd["vgg.classifier.0.weight"].numpy()
    b6 = sd["vgg.classifier.0.bias"].numpy()
    ref = w6 @ pool5.reshape(-1) + b6
    jk = np.asarray(params["backbone"]["fc6"]["kernel"])
    jax_fc6 = pool5.transpose(1, 2, 0).reshape(-1) @ jk + b6
    np.testing.assert_allclose(jax_fc6, ref, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        x = torch.nn.functional.relu(torch.from_numpy(ref))
        want = torch.nn.functional.relu(model.vgg.classifier[3](x))
        got = model.vgg.tail(torch.from_numpy(
            pool5.transpose(1, 2, 0)[None].copy()))
    np.testing.assert_allclose(got.reshape(-1).numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["nms", "top"])
def test_vgg_predict_matches_jax(vgg_setup, mode):
    """Inference.predict of the VGG model against the JAX package's, in
    test mode 'nms' and in mode 'top' (top-N anchors by score, no NMS;
    rpn_top_n 300 of the 1152 anchors, so the top-k branch): the same
    boxes survive, scores and deltas within 1e-3."""
    _, model, _, params, *_ = vgg_setup
    cfg = vgg_config()
    cfg.test.mode = mode
    cfg.test.rpn_top_n = 300
    pcfg = to_port_cfg(cfg)
    b = jsynthetic_batch(cfg, 1, 3, seed=7)
    with jax.default_matmul_precision("float32"):
        want = JaxInference(create_model(cfg), params, cfg).predict(
            b["images"], b["im_hw"], b["labels"])
    old, model.cfg = model.cfg, pcfg
    try:
        got = Inference(model, pcfg, device="cpu").predict(
            b["images"], b["im_hw"], b["labels"])
    finally:
        model.cfg = old
    r = 300 if mode == "top" else cfg.test.rpn_post_nms_top_n
    assert got["rois"].shape == (3, r, 4)
    assert got["gated_conv"].shape == (3, 8, 12, 512)
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  want["roi_valid"])
    np.testing.assert_allclose(got["rois"].numpy(), want["rois"], rtol=1e-4,
                               atol=1e-2)
    for k in ("response", "gated_conv", "cls_score", "cls_prob",
              "bbox_pred"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3,
                                   atol=1e-3, err_msg=k)


@pytest.mark.parametrize("wire", ["float32", "uint8_packed"])
def test_vgg_train_forward_losses_match_jax(vgg_setup, wire):
    """Every loss of the detection-only step (no loss_mask; the response
    loss at C = 512) within 1e-4 relative, on the f32 canvas and on the
    uint8 / bit-packed wire."""
    cfg, model, jmodel, params, batch, targets, j_losses, _ = vgg_setup
    if wire == "uint8_packed":
        batch = to_wire(to_port_cfg(cfg), batch)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        with pytest.MonkeyPatch.context() as mp, \
                jax.default_matmul_precision("float32"):
            mp.setattr(jvgg, "VGG16", _JaxVGG16NoDropout)
            _, j_losses = _jax_loss_fn(jmodel, jbatch,
                                       _jax_targets(*targets))(params)
        j_losses = {k: float(v) for k, v in j_losses.items()}
    model.train()
    with torch.no_grad():
        losses = model.train_forward(to_device(batch, "cpu"), targets)
    model.eval()
    assert set(losses) == set(LOSSES) == set(j_losses)
    for k in LOSSES:
        assert _rel(float(losses[k]), j_losses[k]) <= 1e-4, \
            (k, float(losses[k]), j_losses[k])


def test_vgg_gradients_match_jax(vgg_setup):
    """The backward (the heads, fc7 / fc6 in f32, the ROI crop, the gate at
    C = 512, the RPN, the encoder, conv3_1 .. conv5_3) against jax.grad:
    each trainable leaf within 1e-4 in relative L2 norm; conv1_* and
    conv2_* get no gradient."""
    cfg, model, _, params, batch, targets, _, j_grads = vgg_setup
    model.train()
    model.zero_grad(set_to_none=True)
    losses = model.train_forward(to_device(batch, "cpu"), targets)
    losses["total_loss"].backward()
    model.eval()
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == {f"vgg.features.{i}.{p}" for i in (0, 2, 5, 7)
                      for p in ("weight", "bias")}
    assert all(model.get_parameter(n).grad is None for n in frozen)
    got = _flat(_port_grads_as_jax_tree(model, cfg))
    want = _flat(j_grads)
    trainable, _ = partition_params(params, cfg)
    checked = set()
    for key, leaf in _flat(trainable).items():
        if leaf is None:
            continue
        w, g = np.asarray(want[key]), np.asarray(got[key])
        denom = np.linalg.norm(w)
        assert denom > 0, key
        assert np.linalg.norm(g - w) / denom <= 1e-4, key
        checked.add(key)
    for key in ("['backbone']['fc6']['kernel']",
                "['backbone']['conv5_3']['kernel']",
                "['backbone']['conv3_1']['bias']",
                "['filter_gen']['dynamic_fc']['kernel']",
                "['box_head']['cls_score']['kernel']",
                "['rpn_head']['rpn_conv']['kernel']"):
        assert key in checked, key
    model.zero_grad(set_to_none=True)


def test_vgg_sgd_groups_match_jax(vgg_setup):
    """Each parameter's LR multiplier and weight decay against the JAX
    package's `param_multipliers` and `decay_mask` on the converted tree:
    conv1_* and conv2_* frozen (no group), biases x2 without decay
    (double_bias), weights with weight decay 5e-4, the language group x10."""
    cfg, model, *_ = vgg_setup
    pcfg = to_port_cfg(cfg)
    assert pcfg.train.weight_decay == 5e-4 and pcfg.train.double_bias
    groups = {n: (g["lr_mult"], g["weight_decay"])
              for g in param_groups(model, pcfg) for n in g["names"]}
    # each tensor filled with its own id: the converted tree tells which
    # port tensors each JAX leaf holds
    names = list(model.state_dict())
    ids = {k: np.full(v.shape, i + 1, np.float32)
           for i, (k, v) in enumerate(model.state_dict().items())}
    tree = convert_torch_state_dict(ids, cfg)
    mults = _flat(param_multipliers(tree, cfg))
    decay = _flat(decay_mask(tree, cfg))
    seen = set()
    for leaf, v in _flat(tree).items():
        for i in np.unique(np.asarray(v)):
            name = names[int(i) - 1]
            seen.add(name)
            if mults[leaf] == 0.0:
                assert name not in groups, (name, leaf)
                continue
            want = (mults[leaf], 5e-4 if decay[leaf] else 0.0)
            assert groups[name] == want, (name, leaf, groups[name], want)
    assert seen == set(names)
    assert groups["vgg.classifier.0.bias"] == (2.0, 0.0)
    assert groups["vgg.features.24.weight"] == (1.0, 5e-4)
    assert groups["dynamic_fc_0.bias"] == (20.0, 0.0)


def test_vgg_tail_dropout_draws(rng):
    """fc6 and fc7 dropout in train mode: masks drawn from the generator
    (fc6's, then fc7's), a fraction 1 - p kept and scaled by 1 / (1 - p);
    the same generator state gives the same output; eval mode and
    drop_rate 0 draw nothing; train mode without a generator raises."""
    tail = VGG16(torch.float32)
    torch.nn.init.normal_(tail.classifier[0].weight, 0.0, 0.01)
    crops = torch.from_numpy(rng.randn(6, 7, 7, 512).astype(np.float32))
    tail.train()
    g = torch.Generator().manual_seed(3)
    a = tail.tail(crops, g)
    after = g.get_state()
    b = tail.tail(crops, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    g2 = torch.Generator().manual_seed(3)
    torch.rand((6, 4096), generator=g2)
    torch.rand((6, 4096), generator=g2)
    assert torch.equal(after, g2.get_state())       # two (R, 4096) draws
    kept = (a != 0).float().mean()
    assert 0.2 < float(kept) < 0.3                  # 1/2 of fc6 x 1/2
    with pytest.raises(ValueError, match="Generator"):
        tail.tail(crops)
    tail.eval()
    with torch.no_grad():
        assert torch.equal(tail.tail(crops), tail.tail(crops))


def test_vgg_fc_stack_span_and_rows_counter(vgg_setup, rng, monkeypatch):
    """The fc6 / fc7 stack (`models/vgg.py::fc_stack`) under a CPU
    profiler: one `l2s.vgg_fc` range a tail call, and `vgg.fc_rows` counts
    its rows; with no profiler the span opens no range at all (every
    range opener raises), and the rows are still counted."""
    model = vgg_setup[1]
    crops = torch.from_numpy(rng.randn(5, 7, 7, 512).astype(np.float32))
    before = trace.counters().get("vgg.fc_rows", 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            torch.no_grad():
        model.vgg.tail(crops)
    names = [e.name for e in btrace._events(prof)[0]]
    assert names.count("l2s.vgg_fc") == 1
    assert trace.counters()["vgg.fc_rows"] - before == 5

    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "_open", refuse)
    with torch.no_grad():
        model.vgg.tail(crops)
    assert trace.counters()["vgg.fc_rows"] - before == 10

def test_vgg_reference_checkpoint_and_detection_only_serving(vgg_setup,
                                                              tmp_path):
    """A reference `vgg16_faster_rcnn` file (its keys, fc6 channel-major,
    torchvision's unused classifier.6) restores every tensor of the port's
    model and skips classifier.6 only; the model serves `extract_head`
    and `predict`, and `boxes_to_masks` refuses (no mask head)."""
    cfg, model, *_ = vgg_setup
    pcfg = to_port_cfg(cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["vgg.classifier.6.weight"] = torch.zeros(1000, 4096)
    sd["vgg.classifier.6.bias"] = torch.zeros(1000)
    path = tmp_path / "vgg16_faster_rcnn_iter_1190000.pth"
    torch.save(sd, path)
    fresh = build_model(pcfg, device="cpu", seed=9)
    merged, skipped = tolerant_restore(fresh.state_dict(),
                                       load_params_file(str(path), pcfg))
    assert skipped == {"missing": [], "mismatched": [],
                       "unexpected": ["vgg.classifier.6.bias",
                                      "vgg.classifier.6.weight"]}
    fresh.load_state_dict(merged)
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())
    inf = Inference(fresh, pcfg, device="cpu")
    b = synthetic_batch(pcfg, 1, 2, seed=1)
    assert inf.extract_head(b["images"]).shape == (1, 8, 12, 512)
    out = inf.predict(b["images"], b["im_hw"], b["labels"])
    assert out["bbox_pred"].shape == (2, 32, 324)
    with pytest.raises(ValueError, match="no mask head"):
        inf.boxes_to_masks(out["gated_conv"], out["rois"][:, :2],
                           torch.ones((2, 2), dtype=torch.int64))


@pytest.fixture(scope="module")
def refer_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vgg_eval_data"))
    make_mini_refer(root)
    jp, hp = run_prepro(root, "refcoco", "unc", os.path.join(root, "prepro"),
                        count_threshold=0)
    return root, jp, hp


def test_vgg_detection_only_eval_split_matches_jax(vgg_setup, refer_data):
    """Every image of a mini REFER split through the port's Evaluator and
    the JAX package's Evaluator(device_paste=False): the same sentences
    and det_correct, no segmentation entries, the same summary keys."""
    _, model, jmodel, params, *_ = vgg_setup
    root, jp, hp = refer_data
    cfg = vgg_config()
    cfg.data.image_dir = os.path.join(root, "images", "train2014")
    pcfg = to_port_cfg(cfg)
    acc, jacc = SegEvalAccumulator(), JaxAccumulator()
    ev = Evaluator(model, pcfg, device="cpu")
    jev = JaxEvaluator(jmodel, cfg, device_paste=False)
    loader = GtBatchLoader(jp, hp, pcfg, seed=3)
    jloader = JGtBatchLoader(jp, hp, cfg, seed=3)
    with jax.default_matmul_precision("float32"):
        for split in ("val", "testA"):
            ev.eval_split(loader.iter_test_batches(split, buckets=(4, 8)),
                          acc=acc)
            for b in jloader.iter_test_batches(split, buckets=(4, 8)):
                jev.eval_image(params, b, jacc, sent_valid=b["sent_valid"])
    assert acc.num_sent == jacc.num_sent > 0
    assert acc.det_correct == jacc.det_correct
    assert acc.seg_total == jacc.seg_total == 0
    assert acc.summary() == jacc.summary()


def test_vgg_trainer_on_cpu():
    """Trainer over `vgg` batches with word dropout and VGG16's dropout on
    (the step's generator draws both): finite losses without loss_mask,
    conv1_* and conv2_* bit-identical, fc6, fc7 and conv5_3 moved."""
    cfg = to_port_cfg(vgg_config())
    cfg.model.word_drop_out = 0.5
    cfg.train.display = 1
    batches = [to_wire(cfg, synthetic_batch(cfg, 2, 4, seed=s))
               for s in range(2)]
    tr = Trainer(cfg, FixedBatchLoader(batches), device="cpu")
    before = {n: p.detach().clone()
              for n, p in tr.state.model.named_parameters()}
    last = tr.train(2)
    assert set(last) == set(LOSSES)
    assert all(np.isfinite(v) for v in last.values())
    for n, p in tr.state.model.named_parameters():
        same = torch.equal(before[n], p.detach())
        if not p.requires_grad:
            assert same, n
    for n in ("vgg.classifier.0.weight", "vgg.classifier.3.weight",
              "vgg.features.28.weight"):
        assert not torch.equal(before[n], tr.state.model.get_parameter(n)), n


def test_vgg_cli_train_then_eval_on_cpu(refer_data, tmp_path):
    """`cli.train --variant vgg` takes a step and snapshots it;
    `cli.eval --variant vgg` restores it and scores boxes only: a
    det_results.txt line a split and no mask_results.txt."""
    root = refer_data[0]
    tiny = ["data.canvas_h", "128", "data.canvas_w", "192",
            "model.compute_dtype", "float32", "model.normalize_response",
            "true", "train.grad_clip_norm", "10", "train.learning_rate",
            "1e-5", "train.rpn_pre_nms_top_n", "512",
            "train.rpn_post_nms_top_n", "128", "train.roi_batch_size", "32",
            "test.rpn_pre_nms_top_n", "256", "test.rpn_post_nms_top_n", "32",
            "train.expressions_per_batch", "4"]
    args = ["--variant", "vgg", "--prepro-dir", os.path.join(root, "prepro"),
            "--image-dir", os.path.join(root, "images", "train2014"),
            "--output-dir", str(tmp_path), "--device", "cpu", "--set", *tiny]
    losses = cli_train.main(args + ["--max-iters", "1"])
    assert set(losses) == set(LOSSES)
    assert os.path.isdir(tmp_path / "ckpt" / "iter_1")
    res = cli_eval.main(args + ["--splits", "val", "--sent-buckets", "4",
                                "8"])
    assert res["val"]["overall_iou"] == 0.0
    assert 0.0 <= res["val"]["det_acc"] <= 1.0
    lines = (tmp_path / "det_results.txt").read_text().splitlines()
    assert len(lines) == 1 and "vgg_exp0 iter=1 split=val" in lines[0]
    assert not (tmp_path / "mask_results.txt").exists()
