"""The attribute head of the port against the JAX package, at the tiny
`response` config (resnet26, 128x192, f32) with 6 attributes: the loader's
attribute fields and `iter_attribute_batches` (both packages' prepro with
the same attribute file), `loss_att` and the gradients of `total_loss`
with injected targets, `predict_attribute_scores` on uint8 and f32
canvases, `compute_overall`, and `eval_attributes` (its bookkeeping on
both packages' loaders, and end to end with the port's scorer); also the
weights bridge and SGD groups of `att_head` and the fixture's attribute
file."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lang2seg_tpu.data.fixtures import make_mini_refer
from lang2seg_tpu.data.loader import GtBatchLoader as JGtBatchLoader
from lang2seg_tpu.data.prepro import run_prepro as jrun_prepro
from lang2seg_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from lang2seg_tpu.engine.attributes import (
    compute_overall as jcompute_overall, eval_attributes as jeval_attributes)
from lang2seg_tpu.engine.optimizer import (decay_mask, param_multipliers,
                                           partition_params)
from lang2seg_tpu.models.network import Lang2Seg as JaxLang2Seg
from lang2seg_tpu_torch.data.fixtures import (write_attribute_file,
                                              write_mini_refer)
from lang2seg_tpu_torch.data.loader import GtBatchLoader
from lang2seg_tpu_torch.data.prepro import prepro_data, run_prepro
from lang2seg_tpu_torch.data.refer import REFER
from lang2seg_tpu_torch.engine.attributes import (attribute_scorer,
                                                  compute_overall,
                                                  eval_attributes)
from lang2seg_tpu_torch.engine.optimizer import param_groups
from lang2seg_tpu_torch.engine.train_state import to_device
from lang2seg_tpu_torch.models.network import Lang2Seg, build_model
from tests.test_torch_train import (_jax_loss_fn, _jax_targets, _rel,
                                    _targets)
from tests.test_torch_weights import (_flat, response_config, shared_weights,
                                      to_jax_tree, to_port_cfg)

NUM_ATT = 6
WORDS = ("red", "big", "small", "white", "left", "tall")
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box",
          "loss_mask", "loss_response", "loss_att", "total_loss")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def att_config(**model_kw):
    kw = dict(use_attribute_head=True, num_attributes=NUM_ATT,
              word_drop_out=0.0)
    kw.update(model_kw)
    return response_config(**kw)


@pytest.fixture(scope="module")
def att_refer(tmp_path_factory):
    """The JAX package's mini REFER tree (JPEGs on disk) with an attribute
    file over its refs (some without words), prepro'd by each package;
    (port loader, JAX loader, cfg)."""
    root = str(tmp_path_factory.mktemp("att_refer"))
    make_mini_refer(root, num_images=6, refs_per_image=3, sents_per_ref=2)
    r = np.random.RandomState(0)
    atts = {str(rid): ([] if rid % 5 == 0 else
                       [WORDS[i] for i in r.choice(NUM_ATT, r.randint(1, 4),
                                                   replace=False)])
            for rid in range(1, 19)}
    att_json = os.path.join(root, "atts.json")
    with open(att_json, "w") as f:
        json.dump(atts, f)
    jfiles = jrun_prepro(root, "refcoco", "unc",
                         os.path.join(root, "prepro_jax"), count_threshold=0,
                         att_json=att_json)
    pfiles = run_prepro(root, "refcoco", "unc", os.path.join(root, "prepro"),
                        count_threshold=0, att_json=att_json)
    cfg = att_config()
    cfg.data.image_dir = os.path.join(root, "images", "train2014")
    cfg.train.images_per_batch, cfg.train.expressions_per_batch = 2, 5
    jl = JGtBatchLoader(*jfiles, cfg, seed=3)
    pl = GtBatchLoader(*pfiles, to_port_cfg(cfg), seed=3)
    cfg.model.vocab_size = pl.vocab_size
    return pl, jl, cfg


def test_loader_attribute_fields_match_jax(att_refer):
    pl, jl, _ = att_refer
    assert pl.att_to_ix == jl.att_to_ix and len(pl.att_to_ix) == NUM_ATT
    assert pl.ix_to_att == jl.ix_to_att
    for rid in pl.Refs:
        np.testing.assert_array_equal(pl.att_multihot(rid),
                                      jl.att_multihot(rid))
    for _ in range(4):
        got, want = pl.get_batch("train"), jl.get_batch("train")
        for k in ("att_labels", "att_valid", "labels", "gt_boxes"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["att_labels"].shape == (5, NUM_ATT)
    np.testing.assert_array_equal(pl.decode_labels(got["labels"]),
                                  jl.decode_labels(want["labels"]))


@pytest.mark.parametrize("split", ["train", "val", "testA"])
def test_iter_attribute_batches_match_jax(att_refer, split):
    """The same images in the same order, the same refs, boxes and words;
    canvases within one grey level (the port's resize is cv2's rule in
    NumPy)."""
    pl, jl, _ = att_refer
    got = list(pl.iter_attribute_batches(split, max_refs=4))
    want = list(jl.iter_attribute_batches(split, max_refs=4))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["ref_ids"] == w["ref_ids"]
        assert g["gd_att_wds"] == w["gd_att_wds"]
        np.testing.assert_array_equal(g["ref_valid"], w["ref_valid"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-4)
        assert g["images"].shape == w["images"].shape
        assert np.abs(g["images"].astype(int)
                      - w["images"].astype(int)).max() <= 1


@pytest.fixture(scope="module")
def att_setup():
    """Shared weights, the batch and injected targets of
    tests/test_torch_train.py's slice (2 images x 4 expressions) with
    attribute labels added (one expression invalid), and the JAX losses
    and gradients on them (one eager JAX run)."""
    cfg = att_config()
    model, jmodel, params = shared_weights(cfg, seed=4)
    batch = jsynthetic_batch(cfg, 2, 4, seed=5)
    r = np.random.RandomState(6)
    batch["att_labels"] = (r.rand(4, NUM_ATT) < 0.4).astype(np.float32)
    batch["att_valid"] = np.asarray([True, False, True, True])
    targets = _targets(cfg, batch, seed=6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        (_, j_losses), j_grads = jax.value_and_grad(
            _jax_loss_fn(jmodel, jbatch, _jax_targets(*targets)),
            has_aux=True)(params)
    return (cfg, model, jmodel, params, batch, targets,
            {k: float(v) for k, v in j_losses.items()}, j_grads)


def test_loss_att_matches_jax(att_setup):
    """Every loss, loss_att among them, within 1e-4 relative; without
    att_valid every expression counts, and without att_labels there is no
    loss_att (both as in JAX)."""
    cfg, model, jmodel, params, batch, targets, j_losses, _ = att_setup
    model.train()
    with torch.no_grad():
        losses = model.train_forward(to_device(batch, "cpu"), targets)
        assert set(losses) == set(LOSSES) == set(j_losses)
        for k in LOSSES:
            assert _rel(float(losses[k]), j_losses[k]) <= 1e-4, k
        assert float(losses["loss_att"]) > 0.1
        for drop in ("att_valid", "att_labels"):
            part = {k: v for k, v in batch.items() if k != drop}
            got = model.train_forward(to_device(part, "cpu"), targets)
            with jax.default_matmul_precision("float32"):
                _, want = _jax_loss_fn(jmodel, {k: jnp.asarray(v) for k, v in
                                                part.items()},
                                       _jax_targets(*targets))(params)
            assert set(got) == set(want)
            for k in got:
                assert _rel(float(got[k]), float(want[k])) <= 1e-4, (drop, k)
    model.eval()
    assert "loss_att" not in got


def test_loss_att_gradients_match_jax(att_setup):
    """The backward with the attribute head (its crop of the un-gated map
    reaches the backbone) against jax.grad: each trainable leaf within
    1e-4 in relative L2 norm (tests/test_torch_train.py's tolerance)."""
    cfg, model, _, params, batch, targets, _, j_grads = att_setup
    model.train()
    model.zero_grad(set_to_none=True)
    model.train_forward(to_device(batch, "cpu"), targets)[
        "total_loss"].backward()
    model.eval()
    sd = {k: np.zeros(v.shape, np.float32)
          for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        if p.grad is not None:
            sd[name] = p.grad.detach().numpy()
    got, want = _flat(to_jax_tree(sd, cfg)), _flat(j_grads)
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
    assert checked >= 40 and "['att_head']['kernel']" in want


def test_weights_bridge_with_att_head():
    """init_params gives att_head the JAX tree's shape (the state_dict
    maps onto every JAX param), and from_jax_params carries a random JAX
    tree back bit for bit."""
    from lang2seg_tpu_torch.weights import (from_jax_params, init_params,
                                            state_dict_shapes)
    from tests.test_torch_weights import _jax_param_shapes
    cfg = att_config()
    pcfg = to_port_cfg(cfg)
    sd = init_params(pcfg, 0)
    tree = to_jax_tree({k: v.numpy() for k, v in sd.items()}, cfg)
    assert {k: tuple(np.shape(v)) for k, v in _flat(tree).items()} == \
        _jax_param_shapes(cfg)
    assert tuple(sd["att_head.weight"].shape) == (NUM_ATT, 2048)
    r = np.random.RandomState(0)
    rand = jax.tree_util.tree_map(
        lambda v: r.standard_normal(np.shape(v)).astype(np.float32), tree)
    back = from_jax_params(rand, cfg)
    assert {k: tuple(v.shape) for k, v in back.items()} == \
        state_dict_shapes(pcfg)
    again = _flat(to_jax_tree({k: v.numpy() for k, v in back.items()}, cfg))
    for k, v in _flat(rand).items():
        np.testing.assert_array_equal(np.asarray(again[k]), v, err_msg=k)


def test_att_head_sgd_groups_match_jax():
    """att_head.weight is a weight and att_head.bias a bias, under the
    flagship's double_bias / bias_decay and their opposites."""
    for double_bias, bias_decay in ((False, False), (True, True)):
        cfg = att_config()
        cfg.train.double_bias, cfg.train.bias_decay = double_bias, bias_decay
        pcfg = to_port_cfg(cfg)
        model = build_model(pcfg, device="cpu")
        groups = {n: (g["lr_mult"], g["weight_decay"])
                  for g in param_groups(model, pcfg) for n in g["names"]}
        tree = to_jax_tree({k: v.numpy()
                            for k, v in model.state_dict().items()}, cfg)
        mults = _flat(param_multipliers(tree, cfg))
        decay = _flat(decay_mask(tree, cfg))
        wd = cfg.train.weight_decay
        for name, key in (("att_head.weight", "['att_head']['kernel']"),
                          ("att_head.bias", "['att_head']['bias']")):
            assert groups[name] == (mults[key], wd if decay[key] else 0.0)
        assert groups["att_head.bias"] == (2.0 if double_bias else 1.0,
                                           wd if bias_decay else 0.0)


def test_predict_attribute_scores_match_jax(att_setup):
    """Scores (1, B, A) within 1e-5 of JAX's; a uint8 canvas scores as its
    mean-subtracted f32 copy (within 1e-6) and unlike the raw pixels."""
    cfg, model, jmodel, params, _, _, _, _ = att_setup
    r = np.random.RandomState(0)
    img_u8 = r.randint(0, 256, (1, cfg.data.canvas_h, cfg.data.canvas_w,
                                3)).astype(np.uint8)
    img_f32 = img_u8.astype(np.float32) - np.asarray(
        cfg.data.pixel_means_bgr, np.float32)
    boxes = np.asarray([[[4.0, 4.0, 60.0, 50.0], [10.0, 8.0, 90.0, 100.0],
                         [0.0, 0.0, 191.0, 127.0]]], np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jmodel.apply(
            {"params": params}, jnp.asarray(img_f32), jnp.asarray(boxes),
            method=JaxLang2Seg.predict_attribute_scores))
    model.eval()
    score = attribute_scorer(model, device="cpu")
    got = score(img_f32, boxes)
    assert got.shape == want.shape == (1, 3, NUM_ATT)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(score(img_u8, boxes), got, rtol=0, atol=1e-6)
    raw = score(img_u8.astype(np.float32), boxes)
    assert not np.allclose(raw, got, rtol=1e-3, atol=0)
    assert ((got >= 0) & (got <= 1)).all()


def test_compute_overall_equal_jax():
    r = np.random.RandomState(1)
    cases = [[], [{"gd_att_wds": [], "pred_att_wds": []}],
             [{"gd_att_wds": ["red"], "pred_att_wds": ["blue"]}],
             [{"gd_att_wds": ["red", "big"], "pred_att_wds": ["red"]},
              {"gd_att_wds": ["small"], "pred_att_wds": ["small", "blue"]},
              {"gd_att_wds": ["white"], "pred_att_wds": []}]]
    for _ in range(5):
        cases.append([{"gd_att_wds": list(r.choice(WORDS, r.randint(0, 4))),
                       "pred_att_wds": list(r.choice(WORDS, r.randint(0, 4)))}
                      for _ in range(r.randint(1, 8))])
    for preds in cases:
        got, want = compute_overall(preds), jcompute_overall(preds)
        assert got == want and all(type(got[k]) is type(want[k])
                                   for k in want)


def test_eval_attributes_bookkeeping_matches_jax(att_refer):
    """eval_attributes over each package's loader with one score function
    of the boxes alone: the same refs, predictions and P / R / F1."""
    pl, jl, _ = att_refer

    def score_fn(images, boxes):
        b = np.asarray(boxes)[0]
        z = np.sin(b[:, :1] * 0.37 + b[:, 1:2] * 0.11
                   + np.arange(NUM_ATT)[None] * 1.3)
        return (0.5 + 0.5 * z)[None]
    for split in ("train", "val", "testA"):
        got = eval_attributes(pl, score_fn, split, max_refs=4)
        want = jeval_attributes(jl, score_fn, split, max_refs=4)
        assert got == want and got["n_refs"] > 0, split


def test_eval_attributes_end_to_end(att_setup, att_refer):
    """The port's scorer over the loader's attribute batches: scores in
    [0, 1], P / R / F1 each -1 or in [0, 1]."""
    _, model, _, _, _, _, _, _ = att_setup
    pl, _, _ = att_refer
    res = eval_attributes(pl, attribute_scorer(model, device="cpu"), "val")
    assert res["n_refs"] > 0
    for v in res["overall"].values():
        assert v == -1.0 or 0.0 <= v <= 1.0


def test_entry_points_refuse_missing_card(att_setup, monkeypatch):
    _, model, _, _, _, _, _, _ = att_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        attribute_scorer(model)


def test_write_attribute_file_gives_the_vocab_width(tmp_path):
    """write_attribute_file over a write_mini_refer tree: the in-memory
    prepro keeps exactly n_words attribute words (top-k of 50), every
    fourth ref has none, and a GtBatchLoader batch carries (E, n_words)
    labels; a model with num_attributes = n_words builds."""
    _, read = write_mini_refer(str(tmp_path), ((120, 160),) * 4,
                               (3, 2, 3, 2), ("train", "train", "val",
                                              "testA"))
    path = write_attribute_file(str(tmp_path), 12)
    with open(path) as f:
        atts = json.load(f)
    info, labels = prepro_data(REFER(str(tmp_path)), 10, count_threshold=0,
                               att_json=path)
    assert len(info["att_to_ix"]) == 12
    assert sum(1 for w in atts.values() if not w) == len(atts) // 4
    cfg = to_port_cfg(att_config(num_attributes=12))
    cfg.model.vocab_size = len(info["word_to_ix"])
    loader = GtBatchLoader(info, labels, cfg, seed=0, read_image=read)
    b = loader.get_batch("train", num_images=2, num_expr=6)
    assert b["att_labels"].shape == (6, 12) and b["att_valid"].dtype == bool
    Lang2Seg(cfg)
