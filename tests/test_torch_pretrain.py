"""The Mask R-CNN pretraining stage of the port (the `pretrain` variant: no
language) against the JAX package, at tests/test_network.py::tiny_config
(resnet26, 128x192, f32) with M = 4 GT slots an image:

* the model: no language parameters; `train_forward`'s losses and
  gradients against jax.grad on the same weights and injected targets,
  4 GT boxes an image with distinct masks (and 3 of 4 slots filled for
  the losses), on the f32 canvas and on the uint8 / bit-packed wire; the
  ROI sampler's mask targets at M = 4 given the JAX key chain's draws;
* the weights bridge both ways without `encoder` / `filter_gen`, the SGD
  groups against JAX's multipliers and decay mask, and the recipe link: a
  pretrain state_dict loaded into a `response` Trainer;
* the data: `synthetic_detection_batch`, `make_coco_minus_refer` (and its
  command line) and `CocoDetectionLoader` against the JAX loader (boxes,
  masks and flips identical, images within 2 f32 ulps at the pixel
  scale), its state_dict round trip; `cli.train --variant pretrain` on
  the CPU over the port's prepro files; serving refuses the model.

Tolerances are tests/test_torch_train.py's: losses within 1e-4 relative,
each trainable gradient within 1e-4 in relative L2 norm."""

import json
import os

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from lang2seg_tpu.data import rle as jrle
from lang2seg_tpu.data.coco_detection import \
    CocoDetectionLoader as JCocoDetectionLoader
from lang2seg_tpu.data.coco_detection import \
    make_coco_minus_refer as jmake_coco_minus_refer
from lang2seg_tpu.data.synthetic import \
    synthetic_detection_batch as jsynthetic_detection_batch
from lang2seg_tpu.engine.convert import convert_torch_state_dict
from lang2seg_tpu.engine.optimizer import (decay_mask, param_multipliers,
                                           partition_params)
from lang2seg_tpu.ops.targets import proposal_targets as jproposal_targets
from lang2seg_tpu_torch.cli import make_coco_minus_refer as cli_coco
from lang2seg_tpu_torch.cli import train as cli_train
from lang2seg_tpu_torch.data.coco_detection import (CocoDetectionLoader,
                                                    make_coco_minus_refer)
from lang2seg_tpu_torch.data.fixtures import write_mini_refer
from lang2seg_tpu_torch.data.prepro import run_prepro
from lang2seg_tpu_torch.data.synthetic import (FixedBatchLoader,
                                               synthetic_batch,
                                               synthetic_detection_batch,
                                               to_wire)
from lang2seg_tpu_torch.engine.optimizer import param_groups
from lang2seg_tpu_torch.engine.train_state import to_device
from lang2seg_tpu_torch.engine.trainer import Trainer
from lang2seg_tpu_torch.models.network import Lang2Seg, build_model
from lang2seg_tpu_torch.ops.targets import proposal_targets
from lang2seg_tpu_torch.tools.tiny_step import tiny_inputs
from lang2seg_tpu_torch.weights import (from_jax_params, init_params,
                                        state_dict_shapes)
from tests.test_network import tiny_config
from tests.test_torch_targets import _bg_count, _jitter
from tests.test_torch_train import (_jax_loss_fn, _jax_targets,
                                    _port_grads_as_jax_tree, _rel)
from tests.test_torch_weights import (_flat, _jax_param_shapes,
                                      response_config, shared_weights,
                                      to_port_cfg)

LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box",
          "loss_mask", "total_loss")
LANGUAGE_PREFIXES = ("rnn_encoder.", "dynamic_fc", "response_fc.")
M = 4
# the port's raw tree: (h, w), refs and split of each REFER image, and the
# COCO images without refs
IMAGE_HW = ((60, 80), (80, 60), (64, 64), (60, 80), (80, 60), (72, 96))
REFS = (2, 3, 2, 2, 1, 2)
SPLITS = ("train", "train", "val", "testA", "testB", "train")
EXTRA_HW = ((50, 70), (70, 50), (90, 60))
# each pixel of the f32 canvas is a cv2 INTER_LINEAR value (up to 255) less
# the pixel mean: 2 f32 ulps at 255
IMAGE_ATOL = 2 * float(np.spacing(np.float32(255.0)))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_rle():
    """The JAX codec's NumPy path, whether or not its native library is
    built (the port has no native library)."""
    saved, jrle._lib = jrle._lib, None
    yield
    jrle._lib = saved


def pretrain_config(**train_kw):
    cfg = tiny_config(use_language=False)
    cfg.data.max_gt_per_image = M
    for k, v in train_kw.items():
        setattr(cfg.train, k, v)
    return cfg


@pytest.fixture(scope="module")
def pretrain_setup():
    """Shared weights, 2 images with 4 GT boxes each (tools/tiny_step.py's
    inputs: distinct box masks, 64 rois jittered around the 4 boxes an
    image), and the JAX losses and gradients on the raw f32 batch."""
    cfg = pretrain_config(learning_rate=1e-3)
    pcfg = to_port_cfg(cfg)
    model, jmodel, params = shared_weights(cfg, seed=4)
    _, targets = tiny_inputs(pcfg, seed=5, num_gt=M)
    batch = synthetic_detection_batch(pcfg, 2, num_gt=M, seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        (_, j_losses), j_grads = jax.value_and_grad(
            _jax_loss_fn(jmodel, jbatch, _jax_targets(*targets)),
            has_aux=True)(params)
    return (cfg, model, jmodel, params, batch, targets,
            {k: float(v) for k, v in j_losses.items()}, j_grads)


def test_pretrain_model_has_no_language():
    """Neither package builds the encoder or the filter generator; the
    two trees hold the same tensors."""
    cfg = pretrain_config()
    pcfg = to_port_cfg(cfg)
    keys = state_dict_shapes(pcfg)
    assert not [k for k in keys if k.startswith(LANGUAGE_PREFIXES)]
    model = Lang2Seg(pcfg)
    assert not hasattr(model, "filter_gen")
    assert not hasattr(model, "rnn_encoder")
    jshapes = _jax_param_shapes(cfg)
    assert not [k for k in jshapes if k.startswith(("['encoder']",
                                                    "['filter_gen']"))]
    # the JAX tree holds the frozen BatchNorms' statistics as params
    assert sum(int(np.prod(s)) for s in jshapes.values()) == sum(
        int(np.prod(s)) for s in keys.values())


def test_weights_bridge_without_language():
    """convert_torch_state_dict(port) gives the JAX tree's exact leaves and
    shapes; from_jax_params inverts it bit for bit."""
    cfg = pretrain_config()
    pcfg = to_port_cfg(cfg)
    sd = init_params(pcfg, 0)
    tree = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                    cfg)
    assert {k: tuple(np.shape(v)) for k, v in _flat(tree).items()} == \
        _jax_param_shapes(cfg)
    rng = np.random.RandomState(0)
    rand = jax.tree_util.tree_map(
        lambda v: rng.standard_normal(np.shape(v)).astype(np.float32), tree)
    back = from_jax_params(rand, cfg)
    assert {k: tuple(v.shape) for k, v in back.items()} == \
        state_dict_shapes(pcfg)
    again = _flat(convert_torch_state_dict(
        {k: v.numpy() for k, v in back.items()}, cfg))
    for k, v in _flat(rand).items():
        np.testing.assert_array_equal(np.asarray(again[k]), v, err_msg=k)


@pytest.mark.parametrize("wire,num_gt", [("float32", M),
                                         ("uint8_packed", M),
                                         ("float32", 3)])
def test_pretrain_losses_match_jax(pretrain_setup, wire, num_gt):
    """Every loss within 1e-4 relative; no response or caption loss. With
    3 of 4 slots filled, the padding slot is held out by gt_valid in both."""
    cfg, model, jmodel, params, batch, targets, j_losses, _ = pretrain_setup
    pcfg = to_port_cfg(cfg)
    if num_gt != M:
        batch, targets = tiny_inputs(pcfg, seed=8, num_gt=num_gt)
        batch = synthetic_detection_batch(pcfg, 2, num_gt=num_gt, seed=8)
        assert not batch["gt_valid"][:, num_gt:].any()
    if wire == "uint8_packed":
        batch = to_wire(pcfg, batch)
        assert batch["gt_masks"].shape == (2, M, 128, 192 // 8)
    if wire != "float32" or num_gt != M:
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        with jax.default_matmul_precision("float32"):
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


def test_pretrain_gradients_match_jax(pretrain_setup):
    """The whole backward (heads, mask loss over 4 GTs' targets, ROI crop,
    RPN, the backbone map) against jax.grad: each trainable leaf within
    1e-4 in relative L2 norm; frozen leaves get no gradient.

    The port runs its CPU convolutions without oneDNN here. oneDNN sums in
    another order than XLA's CPU convolutions, and on these inputs one
    pre-activation of layer4's first block lies within f32 rounding of
    zero (+1.6e-5 against -1.1e-5, in three duplicated ROIs), so its ReLU
    opens on one side only: layer4's kernel gradients then move 5.4e-4
    and layer2-3's 1.7e-4. Without oneDNN the port matches XLA's sums to
    ~3e-7, and the comparison holds the logic, not the summation order."""
    cfg, model, _, params, batch, targets, _, j_grads = pretrain_setup
    model.train()
    model.zero_grad(set_to_none=True)
    with torch.backends.mkldnn.flags(enabled=False):
        losses = model.train_forward(to_device(batch, "cpu"), targets)
        losses["total_loss"].backward()
    model.eval()
    got = _flat(_port_grads_as_jax_tree(model, cfg))
    want = _flat(j_grads)
    trainable, _ = partition_params(params, cfg)
    checked = 0
    for key, leaf in _flat(trainable).items():
        if leaf is None:
            continue
        w, g = np.asarray(want[key]), np.asarray(got[key])
        denom = np.linalg.norm(w)
        assert denom > 0, key
        assert np.linalg.norm(g - w) / denom <= 1e-4, key
        checked += 1
    assert checked == 26
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(model.get_parameter(n).grad is None for n in frozen)
    for name in ("mask_pred_net.weight", "rpn_net.weight",
                 "resnet.layer3.0.conv1.weight"):
        assert float(model.get_parameter(name).grad.abs().max()) > 0, name


def test_mask_targets_of_four_gts_match_jax():
    """The ROI sampler at M = 4 with a distinct random mask a GT: rois
    around every GT, so that the fg slots' matched GT (the mask gather's
    index) runs over 0..3; identical to the JAX sampler given its key
    chain's draws."""
    rng = np.random.RandomState(11)
    h, w, p = 128, 192, 96
    gt = np.asarray([[[10, 12, 60, 70, 3], [80, 20, 150, 60, 7],
                      [30, 80, 100, 120, 12], [120, 70, 185, 125, 40]],
                     [[5, 5, 90, 90, 1], [100, 10, 180, 100, 2],
                      [20, 95, 70, 125, 5], [0, 0, 0, 0, 0]]], np.float32)
    gt_valid = np.asarray([[True] * 4, [True, True, True, False]])
    rois = np.stack([np.concatenate([_jitter(rng, g, p // 4, 8.0)
                                     for g in gt[i, [0, 1, 2, i % 4 - 1]]])
                     for i in range(2)])
    roi_valid = np.ones((2, p), bool)
    masks = (rng.uniform(size=(2, M, h, w)) > 0.5).astype(np.uint8)
    kw = dict(num_rois=32, fg_fraction=0.5, mask_size=14)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    want, draws = [], []
    for i in range(2):
        want.append(jproposal_targets(
            jnp.asarray(rois[i]), jnp.asarray(roi_valid[i]),
            jnp.asarray(gt[i]), jnp.asarray(gt_valid[i]),
            jnp.asarray(masks[i]), keys[i], **kw))
        k_fg, k_bg, k_rep = jax.random.split(keys[i], 3)
        safe_bg = max(_bg_count(rois[i], roi_valid[i], gt[i], gt_valid[i]),
                      1)
        rep = np.asarray(jax.random.randint(k_rep, (32,), 0, safe_bg))
        draws.append((np.asarray(jax.random.uniform(k_fg, (p + M,))),
                      np.asarray(jax.random.uniform(k_bg, (p + M,))),
                      ((rep + 0.5) / safe_bg).astype(np.float32)))
    got = proposal_targets(
        torch.from_numpy(rois), torch.from_numpy(roi_valid),
        torch.from_numpy(gt), torch.from_numpy(gt_valid),
        torch.from_numpy(masks),
        draws=[torch.from_numpy(np.stack(d)) for d in zip(*draws)], **kw)
    for i in range(2):
        for name in ("rois", "labels", "roi_valid", "mask_targets",
                     "mask_weight"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(want[i], name)),
                                          err_msg=f"image {i}: {name}")
    fg_classes = {int(c) for c in got.labels[0, :16]}
    assert fg_classes == {3, 7, 12, 40}


@pytest.mark.parametrize("double_bias", [False, True])
def test_pretrain_sgd_groups_match_jax(double_bias):
    """Each trainable parameter's LR multiplier and weight decay against
    the JAX package's `param_multipliers` and `decay_mask` for the
    no-language tree (no language group); frozen leaves are JAX's
    multiplier-0 leaves."""
    cfg = pretrain_config(double_bias=double_bias)
    pcfg = to_port_cfg(cfg)
    model = build_model(pcfg, device="cpu")
    groups = {n: (g["lr_mult"], g["weight_decay"])
              for g in param_groups(model, pcfg) for n in g["names"]}
    assert {m for m, _ in groups.values()} == \
        ({1.0, 2.0} if double_bias else {1.0})
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = convert_torch_state_dict(sd, cfg)
    mults = _flat(param_multipliers(tree, cfg))
    decay = _flat(decay_mask(tree, cfg))
    params = dict(model.named_parameters())
    for name in params:
        one = {k: np.zeros_like(v) for k, v in sd.items()}
        one[name] = np.ones_like(sd[name])
        leaf, = [k for k, v in _flat(convert_torch_state_dict(one, cfg))
                 .items() if np.any(v)]
        if mults[leaf] == 0.0:
            assert name not in groups and not params[name].requires_grad
            continue
        want = (mults[leaf], cfg.train.weight_decay if decay[leaf] else 0.0)
        assert groups[name] == want, (name, leaf, groups[name], want)
    assert len(groups) >= 20


def test_pretrain_weights_load_into_a_response_trainer():
    """The reference's recipe link: a pretrain state_dict transferred into
    a `response` Trainer by load_pretrained. Every shared tensor is taken
    as it is; only the language tensors are reported missing."""
    pcfg = to_port_cfg(pretrain_config())
    pre = init_params(pcfg, 9)
    rcfg = to_port_cfg(response_config())
    batch = to_wire(rcfg, synthetic_batch(rcfg, 2, 4, seed=0))
    trainer = Trainer(rcfg, FixedBatchLoader([batch]), device="cpu", seed=1)
    skipped = trainer.load_pretrained(pre)
    missing = skipped["missing"]
    assert missing and all(k.startswith(LANGUAGE_PREFIXES) for k in missing)
    assert skipped["mismatched"] == [] and skipped["unexpected"] == []
    sd = trainer.state.model.state_dict()
    assert set(sd) - set(missing) == set(pre)
    for k, v in pre.items():
        assert torch.equal(sd[k], v), k
    losses = trainer.train(1)
    assert "loss_response" in losses and np.isfinite(losses["total_loss"])


def test_pretrain_model_cannot_be_served():
    pcfg = to_port_cfg(pretrain_config())
    model = build_model(pcfg, device="cpu")
    batch = to_device(synthetic_batch(pcfg, 1, 2), "cpu")
    with pytest.raises(NotImplementedError, match="network.py:446"):
        model.test_forward({k: batch[k] for k in ("images", "im_hw",
                                                  "labels")})


@pytest.mark.parametrize("num_gt", [3, 4])
def test_synthetic_detection_batch_matches_jax(num_gt):
    cfg = pretrain_config()
    got = synthetic_detection_batch(to_port_cfg(cfg), 3, num_gt, seed=2)
    want = jsynthetic_detection_batch(cfg, 3, num_gt, seed=2)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["gt_valid"].sum()) == 3 * num_gt


# ------------------------------------------------------------------ data


@pytest.fixture(scope="module")
def coco_tree(tmp_path_factory):
    """The port's raw tree with each image also written as PNG bytes under
    its COCO file name, so that the JAX loader's cv2.imread reads the
    pixels the port's `read_image` returns."""
    root = str(tmp_path_factory.mktemp("coco_tree"))
    coco, read = write_mini_refer(root, IMAGE_HW, REFS, SPLITS, EXTRA_HW,
                                  seed=3)
    image_dir = os.path.join(root, "images", "train2014")
    os.makedirs(image_dir)
    with open(coco) as f:
        for im in json.load(f)["images"]:
            ok, png = cv2.imencode(".png", read(im["file_name"]))
            assert ok
            with open(os.path.join(image_dir, im["file_name"]), "wb") as g:
                g.write(png.tobytes())
    return root, coco, image_dir, read


def test_make_coco_minus_refer_matches_jax(coco_tree, tmp_path):
    """The same JSON as the JAX function's; exactly the images of the val
    and test refs are gone, with their annotations."""
    root, coco, _, _ = coco_tree
    roots = [(root, "refcoco", "unc")]
    n = make_coco_minus_refer(coco, roots, str(tmp_path / "port.json"))
    jn = jmake_coco_minus_refer(coco, roots, str(tmp_path / "jax.json"))
    got = json.loads((tmp_path / "port.json").read_text())
    assert n == jn and got == json.loads((tmp_path / "jax.json").read_text())
    with open(coco) as f:
        full = json.load(f)
    held_out = {1000 + i for i, s in enumerate(SPLITS) if s != "train"}
    assert {im["id"] for im in full["images"]} - \
        {im["id"] for im in got["images"]} == held_out
    assert n == len(IMAGE_HW) + len(EXTRA_HW) - len(held_out)
    assert not [a for a in got["annotations"] if a["image_id"] in held_out]
    out = str(tmp_path / "cli" / "instances.json")
    assert cli_coco.main(["--coco-instances", coco, "--data-root", root,
                          "--out", out, "--refer", "refcoco:unc"]) == n
    assert json.loads(open(out).read()) == got


def test_make_coco_minus_refer_without_some_splits(tmp_path):
    """A REFER dataset with train, val and test refs only (refcocog_umd's
    splits): the port drops exactly the val and test images. The JAX
    function asks getImgIds(ref_ids=[]) for the empty testA and testB,
    which answers every image of the dataset, and keeps only the COCO
    images outside it (ROADMAP Queue 3)."""
    root = str(tmp_path)
    coco, _ = write_mini_refer(root, IMAGE_HW[:4], REFS[:4],
                               ("train", "val", "test", "train"), EXTRA_HW,
                               dataset="refcocog", split_by="umd", seed=4)
    roots = [(root, "refcocog", "umd")]
    n = make_coco_minus_refer(coco, roots, str(tmp_path / "port.json"))
    got = json.loads((tmp_path / "port.json").read_text())
    assert {im["id"] for im in got["images"]} == \
        {1000, 1003} | {1004 + i for i in range(len(EXTRA_HW))}
    assert n == 2 + len(EXTRA_HW)
    assert jmake_coco_minus_refer(coco, roots,
                                  str(tmp_path / "jax.json")) == len(EXTRA_HW)


def _loader_cfg():
    cfg = pretrain_config()
    cfg.train.images_per_batch = 3
    return cfg


@pytest.mark.parametrize("use_flipped", [True, False])
def test_coco_loader_matches_jax(coco_tree, tmp_path, use_flipped):
    """Five batches of 3 images (an epoch of 9 images; the fourth wraps):
    the same images in the same order, flips, GT boxes, classes, valid
    slots and masks as the JAX loader, bit for bit; the images within 2
    f32 ulps at the pixel scale (cv2.resize against the port's copy of
    its rule). Some images hold more than M = 4 annotations, so `choice`
    draws too."""
    root, coco, image_dir, read = coco_tree
    cfg = _loader_cfg()
    port = CocoDetectionLoader(coco, image_dir, to_port_cfg(cfg),
                               use_flipped=use_flipped, seed=5,
                               read_image=read)
    jax_ = JCocoDetectionLoader(coco, image_dir, cfg,
                                use_flipped=use_flipped, seed=5)
    assert port.ids == jax_.ids and port.cat_to_contig == jax_.cat_to_contig
    assert max(len(a) for a in port.imgToAnns.values()) > M
    kept = sum(len(a) for a in port.imgToAnns.values())
    with open(coco) as f:
        assert kept < len(json.load(f)["annotations"])   # crowd, degenerate
    wrapped = []
    for _ in range(5):
        got, want = port.get_batch(), jax_.get_batch()
        assert set(got) == set(want)
        for k in ("im_hw", "img_idx", "gt_boxes", "gt_valid", "gt_masks"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["images"].dtype == np.float32
        assert float(np.abs(got["images"] - want["images"]).max()) \
            <= IMAGE_ATOL
        assert got["wrapped"] == want["wrapped"]
        wrapped.append(got["wrapped"])
        assert got["gt_valid"].any(1).all() and got["gt_masks"].any()
    assert wrapped == [False, False, False, True, False]
    assert np.array_equal(port.rng.get_state()[1], jax_.rng.get_state()[1])


def test_coco_loader_state_round_trip(coco_tree):
    """A loader restored from another's state_dict draws its next batch."""
    _, coco, image_dir, read = coco_tree
    cfg = to_port_cfg(_loader_cfg())
    a = CocoDetectionLoader(coco, image_dir, cfg, seed=1, read_image=read)
    a.get_batch()
    state = a.state_dict()
    b = CocoDetectionLoader(coco, image_dir, cfg, seed=99, read_image=read)
    b.load_state_dict(state)
    for _ in range(3):
        x, y = a.get_batch(), b.get_batch()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_coco_batch_trains_through_the_wire(coco_tree):
    """A loader batch in the wire formats through two pretrain SGD steps on
    the CPU: finite losses, the RPN moves, frozen layers stay."""
    from lang2seg_tpu_torch.engine.train_state import (create_train_state,
                                                       train_step)
    _, coco, image_dir, read = coco_tree
    cfg = to_port_cfg(_loader_cfg())
    loader = CocoDetectionLoader(coco, image_dir, cfg, seed=2,
                                 read_image=read)
    state = create_train_state(cfg, device="cpu")
    model = state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        batch = to_wire(cfg, loader.get_batch())
        assert batch["images"].dtype == np.uint8
        losses = train_step(state, to_device(batch, "cpu"), g)
        assert set(losses) == set(LOSSES)
        assert all(np.isfinite(float(v)) for v in losses.values())
    after = dict(model.named_parameters())
    assert not torch.equal(before["rpn_net.weight"], after["rpn_net.weight"])
    assert all(torch.equal(before[n], p) for n, p in after.items()
               if not p.requires_grad)


def test_cli_train_pretrain_on_cpu(coco_tree, tmp_path):
    """`cli.train --variant pretrain` over the port's prepro files of the
    REFER tree (each expression's GT its one target, its words unused):
    2 steps, a snapshot, no language tensors in it."""
    root, _, image_dir, _ = coco_tree
    prepro = str(tmp_path / "prepro")
    run_prepro(root, "refcoco", "unc", prepro, count_threshold=0)
    tiny = ["data.canvas_h", "128", "data.canvas_w", "192",
            "model.backbone", "resnet26", "model.compute_dtype", "float32",
            "train.grad_clip_norm", "10", "train.learning_rate", "1e-5",
            "train.rpn_pre_nms_top_n", "512", "train.rpn_post_nms_top_n",
            "128", "train.roi_batch_size", "32",
            "train.expressions_per_batch", "4"]
    losses = cli_train.main(["--variant", "pretrain", "--prepro-dir", prepro,
                             "--image-dir", image_dir, "--output-dir",
                             str(tmp_path / "out"), "--device", "cpu",
                             "--max-iters", "2", "--set", *tiny])
    assert set(losses) == set(LOSSES)
    assert all(np.isfinite(v) for v in losses.values())
    saved = torch.load(tmp_path / "out" / "ckpt" / "iter_2" / "state.pth",
                       map_location="cpu", weights_only=False)["model"]
    assert saved and not [k for k in saved
                          if k.startswith(LANGUAGE_PREFIXES)]
