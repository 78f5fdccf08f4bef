"""MobileNetV1 and ROI max pooling in the port against the JAX package, at
tests/test_network.py::tiny_config (128x192, f32) with the `response`
conditioning, `backbone=mobilenet_v1` and C4 512, in pooling modes 'crop'
and 'pool':

* the weights: JAX `create_train_state`'s params (its BatchNorms
  perturbed, so that every statistic is exercised) through
  `weights.from_jax_params`; the depthwise kernels (3, 3, 1, C) -> (C, 1,
  3, 3), lecun-normal over a fan-in of 9 as flax draws them;
* `MobileNetV1.head` / `tail`, `train_forward`'s losses and gradients on
  shared injected targets, `test_forward`, one SGD step on every tensor
  the port trains, the SGD groups against JAX's multipliers;
* the JAX fault the port does not copy: JAX's optimizer moves the
  MobileNet BatchNorms (`stem_bn`, `dw_bn`, `pw_bn` escape its `bn*`
  test), the port's stay fixed buffers;
* `cycle_response` on MobileNetV1: JAX's captioner takes its input width
  from the 2 x 1024 features; the port's is sized by the config, which
  must say 2048, and its caption loss raises, naming the keys, when the
  config disagrees with the features.

Tolerances are tests/test_torch_train.py's (losses within 1e-4 relative,
gradients and updates within 1e-4 in relative L2 norm) and
tests/test_torch_models.py's (the backbone stack within 1e-3). The
gradients are taken with oneDNN off on the port's side, as in
tests/test_torch_pretrain.py: its convolutions sum in another order than
XLA's, and a ReLU input within f32 rounding of zero can open on one side
only."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lang2seg_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from lang2seg_tpu.data.synthetic import synthetic_test_batch
from lang2seg_tpu.engine.convert import convert_torch_state_dict
from lang2seg_tpu.engine.optimizer import (build_optimizer as jbuild_optimizer,
                                           decay_mask, merge_params,
                                           param_multipliers,
                                           partition_params)
from lang2seg_tpu.engine.train_state import create_model, create_train_state
from lang2seg_tpu.models.network import Lang2Seg as JaxLang2Seg
from lang2seg_tpu_torch.engine.optimizer import param_groups
from lang2seg_tpu_torch.engine.train_state import (create_train_state as
                                                   port_train_state,
                                                   to_device, train_step)
from lang2seg_tpu_torch.models.mobilenet import DWSep
from lang2seg_tpu_torch.models.network import build_model
from lang2seg_tpu_torch.weights import (from_jax_params, init_params,
                                        state_dict_shapes)
from tests.test_torch_train import (_jax_loss_fn, _jax_targets, _rel,
                                    _targets)
from tests.test_torch_weights import _flat, response_config, to_port_cfg

LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box",
          "loss_mask", "loss_response", "total_loss")
BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def mobilenet_config(pooling_mode="crop", **model_kw):
    kw = dict(backbone="mobilenet_v1", c4_feat_dim=512, word_drop_out=0.0,
              pooling_mode=pooling_mode)
    kw.update(model_kw)
    cfg = response_config(**kw)
    cfg.train.learning_rate = 1e-3
    return cfg


def mobilenet_to_jax(sd):
    """The port's `mobilenet.*` entries (numpy) -> the JAX backbone
    subtree: convs OIHW -> HWIO `kernel`, BatchNorm buffers -> scale /
    bias / mean / var."""
    inv = {v: k for k, v in BN_LEAVES.items()}
    tree = {}
    for key, v in sd.items():
        if not key.startswith("mobilenet."):
            continue
        *mods, leaf = key.split(".")[1:]
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        if mods[-1].endswith("_bn"):
            node[inv[leaf]] = jnp.asarray(np.array(v))
        else:
            node["kernel"] = jnp.asarray(np.array(v).transpose(2, 3, 1, 0))
    return tree


def to_jax(sd, cfg):
    """A port state_dict (numpy values) -> the JAX params tree: the JAX
    package's convert_torch_state_dict for every part it knows, the
    MobileNet backbone by `mobilenet_to_jax`."""
    tree = convert_torch_state_dict(
        {k: v for k, v in sd.items() if not k.startswith("mobilenet.")}, cfg)
    tree["backbone"] = mobilenet_to_jax(sd)
    return tree


@pytest.fixture(scope="module")
def jax_params():
    """The params JAX `create_train_state` draws for the tiny MobileNet
    config, with every BatchNorm perturbed (scale, bias, mean, var
    random; var positive) and the RPN class weights scaled by 100 (near-
    tied objectness at the flax init; tests/test_torch_slice.py)."""
    cfg = mobilenet_config()
    _, _, state = create_train_state(cfg)
    params = jax.tree_util.tree_map(np.array, jax.device_get(state.params))
    rng = np.random.RandomState(11)
    bb = params["backbone"]
    for mod in [bb["stem_bn"]] + [bb[b][p] for b in bb if b != "stem"
                                  and b != "stem_bn" for p in ("dw_bn",
                                                               "pw_bn")]:
        n = mod["scale"].shape[0]
        mod["scale"] = (0.5 + rng.rand(n)).astype(np.float32)
        mod["bias"] = (0.2 * rng.randn(n)).astype(np.float32)
        mod["mean"] = (0.2 * rng.randn(n)).astype(np.float32)
        mod["var"] = (0.5 + rng.rand(n)).astype(np.float32)
    for k in ("kernel", "bias"):
        params["rpn_head"]["rpn_cls"][k] = params["rpn_head"]["rpn_cls"][k] \
            * 100.0
    return params


def port_model(cfg, params):
    return build_model(to_port_cfg(cfg), device="cpu",
                       state_dict=from_jax_params(params, to_port_cfg(cfg)))


@pytest.fixture(scope="module", params=["crop", "pool"])
def mb_setup(request, jax_params):
    """Per pooling mode: the port's model on JAX's weights, a 2-image x
    4-expression batch with injected targets, and JAX's losses and
    gradients on them (one jax.value_and_grad). In pool mode JAX runs
    eagerly: jitted on the CPU, XLA computes roi_max_pool's bin widths
    as products with 1/7 and moves bin edges (60,238 of this batch's
    3,211,264 pooled values; tests/test_torch_roi_pool.py), where eager
    JAX and the reference's oracle keep the true quotient, as the port
    does."""
    cfg = mobilenet_config(request.param)
    model = port_model(cfg, jax_params)
    batch = jsynthetic_batch(cfg, 2, 4, seed=5)
    targets = _targets(cfg, batch, seed=6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.value_and_grad(
        _jax_loss_fn(create_model(cfg), jbatch, _jax_targets(*targets)),
        has_aux=True)
    if request.param == "crop":
        fn = jax.jit(fn)
    with jax.default_matmul_precision("float32"):
        (_, j_losses), j_grads = fn(jax_params)
    return (cfg, model, batch, targets,
            {k: float(v) for k, v in j_losses.items()},
            jax.device_get(j_grads))


def test_mobilenet_weights_bridge(jax_params):
    """from_jax_params covers every entry of the port's MobileNet
    state_dict with its shape; mobilenet_to_jax (the test's inverse) gives
    the JAX tree back bit for bit; the depthwise weights are (C, 1, 3, 3),
    and the port's init draws them lecun-normal over a fan-in of 9 (std
    1/3) as flax does."""
    cfg = mobilenet_config()
    pcfg = to_port_cfg(cfg)
    sd = from_jax_params(jax_params, pcfg)
    shapes = state_dict_shapes(pcfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == shapes
    names = [k for k in shapes if k.startswith("mobilenet.")]
    assert len(names) == 5 + 13 * 10
    assert shapes["mobilenet.block3.dw.weight"] == (128, 1, 3, 3)
    assert shapes["mobilenet.tail1.pw.weight"] == (1024, 1024, 1, 1)
    back = _flat(mobilenet_to_jax({k: v.numpy() for k, v in sd.items()}))
    want = _flat(jax_params["backbone"])
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)
    init = init_params(pcfg, 0)
    dw = init["mobilenet.block10.dw.weight"]
    assert abs(float(dw.std()) - 1 / 3) < 0.02
    assert abs(float(init["mobilenet.stem.weight"].std())
               - (1 / 27) ** 0.5) < 0.02
    for bn in ("stem_bn", "block0.dw_bn", "tail1.pw_bn"):
        assert torch.equal(init[f"mobilenet.{bn}.running_var"],
                           torch.ones_like(init[f"mobilenet.{bn}.weight"]))


def test_mobilenet_head_and_tail_match_jax(jax_params, rng):
    """MobileNetV1's head (stride 16, 512 channels) on images and its tail
    (two 1024-wide blocks) on 7x7 crops against JAX's, within 1e-3 of the
    max |value| (tests/test_torch_models.py's backbone tolerance); a
    depthwise block alone within 1e-4."""
    cfg = mobilenet_config()
    model = port_model(cfg, jax_params)
    jmodel = create_model(cfg)
    images = (rng.randn(2, 64, 96, 3) * 40.0).astype(np.float32)
    crops = rng.randn(5, 7, 7, 512).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want_head = np.asarray(jmodel.apply(
            {"params": jax_params}, images,
            method=lambda m, x: m.backbone.head(x)))
        want_tail = np.asarray(jmodel.apply(
            {"params": jax_params}, crops,
            method=lambda m, x: m.backbone.tail(x)))
    with torch.no_grad():
        got_head = model.mobilenet.head(torch.from_numpy(images)).numpy()
        got_tail = model.mobilenet.tail(torch.from_numpy(crops)).numpy()
    assert got_head.shape == want_head.shape == (2, 4, 6, 512)
    assert got_tail.shape == want_tail.shape == (5, 7, 7, 1024)
    for got, want in ((got_head, want_head), (got_tail, want_tail)):
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    assert isinstance(model.mobilenet.block3, DWSep)
    assert model.mobilenet.block3.dw.groups == 128


def test_mobilenet_train_forward_losses_match_jax(mb_setup):
    """Every loss within 1e-4 relative, crop and pool."""
    cfg, model, batch, targets, j_losses, _ = mb_setup
    model.train()
    with torch.no_grad():
        losses = model.train_forward(to_device(batch, "cpu"), targets)
    model.eval()
    assert set(losses) == set(LOSSES) == set(j_losses)
    for k in LOSSES:
        assert _rel(float(losses[k]), j_losses[k]) <= 1e-4, \
            (k, float(losses[k]), j_losses[k])


def _port_grads(model):
    return {n: p.grad.detach().numpy() for n, p in model.named_parameters()
            if p.grad is not None}


def test_mobilenet_gradients_match_jax(mb_setup):
    """The backward (heads, the MobileNet tail, the ROI crop or max pool
    with its argmax backward, the gate at C = 512, the RPN, the encoder,
    every MobileNet conv) against jax.grad: each tensor the port trains
    within 1e-4 in relative L2 norm; the BatchNorms are buffers and get
    none."""
    cfg, model, batch, targets, _, j_grads = mb_setup
    model.train()
    model.zero_grad(set_to_none=True)
    with torch.backends.mkldnn.flags(enabled=False):
        losses = model.train_forward(to_device(batch, "cpu"), targets)
        losses["total_loss"].backward()
    model.eval()
    grads = _port_grads(model)
    model.zero_grad(set_to_none=True)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    assert not any("_bn." in n for n in grads)
    sd = {k: np.zeros(v.shape, np.float32)
          for k, v in model.state_dict().items()}
    sd.update(grads)
    got = _flat(to_jax(sd, cfg))
    want = _flat(j_grads)
    checked = 0
    for key, g in got.items():
        if "_bn'" in key:
            continue
        w = np.asarray(want[key])
        denom = np.linalg.norm(w)
        assert denom > 0, key
        assert np.linalg.norm(np.asarray(g) - w) / denom <= 1e-4, key
        checked += 1
    assert checked >= 40
    for key in ("['backbone']['stem']['kernel']",
                "['backbone']['block5']['dw']['kernel']",
                "['backbone']['tail1']['pw']['kernel']"):
        assert key in got


@pytest.mark.parametrize("pooling", ["crop", "pool"])
def test_mobilenet_test_forward_matches_jax(jax_params, pooling):
    """`test_forward` of one image with 3 expressions against JAX's: the
    same proposals survive NMS, boxes within 1e-2 px, scores, deltas, the
    response and the gated map within 1e-3."""
    cfg = mobilenet_config(pooling)
    model = port_model(cfg, jax_params)
    b = synthetic_test_batch(cfg, 3, seed=7)
    with jax.default_matmul_precision("float32"):
        want = jax.device_get(create_model(cfg).apply(
            {"params": jax_params}, {k: jnp.asarray(v) for k, v in b.items()},
            method=JaxLang2Seg.test_forward))
    got = model.test_forward({k: torch.from_numpy(np.asarray(v))
                              for k, v in b.items()})
    assert got["gated_conv"].shape == (3, 8, 12, 512)
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  np.asarray(want["roi_valid"]))
    np.testing.assert_allclose(got["rois"].numpy(), want["rois"], rtol=1e-4,
                               atol=1e-2)
    for k in ("response", "gated_conv", "cls_score", "cls_prob",
              "bbox_pred"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)


@pytest.fixture(scope="module")
def sgd_step(mb_setup):
    """One SGD step of both packages from each pooling mode's gradients,
    at LR 1 (the updates far above the parameters' own f32 rounding) and
    without
    clipping (JAX's global norm takes in the BatchNorm gradients it should
    not have): (cfg, port state after train_step, JAX params before, JAX
    params after)."""
    cfg, model, batch, targets, _, j_grads = mb_setup
    cfg = copy.deepcopy(cfg)
    cfg.train.learning_rate = 1.0
    cfg.train.grad_clip_norm = 0.0
    params = jax.tree_util.tree_map(
        np.array, to_jax({k: v.numpy() for k, v in
                          model.state_dict().items()}, cfg))
    state = port_train_state(to_port_cfg(cfg), device="cpu",
                             state_dict=model.state_dict())
    with torch.backends.mkldnn.flags(enabled=False):
        train_step(state, to_device(batch, "cpu"), None, targets)
    trainable, frozen = partition_params(params, cfg)
    tx = jbuild_optimizer(trainable, cfg)
    g_tr, _ = partition_params(j_grads, cfg)
    updates, _ = tx.update(g_tr, tx.init(trainable), trainable)
    new = merge_params(optax.apply_updates(trainable, updates), frozen)
    return cfg, state, params, jax.device_get(new)


def test_mobilenet_sgd_step_matches_jax(sgd_step):
    """`train_step` against JAX's gradients through its optimizer chain:
    the update of every tensor the port trains (every MobileNet conv
    included) within 1e-4 in relative L2 norm."""
    cfg, state, old, new = sgd_step
    got = _flat(to_jax({k: v.detach().numpy() for k, v in
                        state.model.state_dict().items()}, cfg))
    old, new = _flat(old), _flat(new)
    checked = []
    for key, w in new.items():
        if "_bn'" in key:
            continue
        d_w = np.asarray(w) - np.asarray(old[key])
        d_g = np.asarray(got[key]) - np.asarray(old[key])
        assert np.any(d_w), key                      # nothing frozen
        assert np.linalg.norm(d_g - d_w) / np.linalg.norm(d_w) <= 1e-4, key
        checked.append(key)
    assert len(checked) >= 40
    # every MobileNet conv: the stem and 13 blocks' dw and pw
    assert sum(k.startswith("['backbone']") for k in checked) == 27


def test_jax_moves_mobilenet_batchnorm_port_keeps_it(sgd_step):
    """The JAX fault the port does not copy: JAX's optimizer trains the
    MobileNet BatchNorms (their names `stem_bn`, `dw_bn`, `pw_bn` escape
    its `bn*` frozen test), so one step moves all four statistics of
    `stem_bn`; the port holds them as buffers, outside every SGD group,
    bit-identical after the step."""
    cfg, state, old, new = sgd_step
    for leaf in ("scale", "bias", "mean", "var"):
        moved = (np.asarray(new["backbone"]["stem_bn"][leaf])
                 - np.asarray(old["backbone"]["stem_bn"][leaf]))
        assert np.abs(moved).max() > 0, leaf
    buffers = dict(state.model.named_buffers())
    for leaf, name in BN_LEAVES.items():
        key = f"mobilenet.stem_bn.{name}"
        np.testing.assert_array_equal(
            buffers[key].numpy(), old["backbone"]["stem_bn"][leaf])
    grouped = {n for g in state.optimizer.param_groups for n in g["names"]}
    assert not any("_bn." in n for n in grouped)


def test_mobilenet_sgd_groups_match_jax():
    """Each MobileNet parameter's LR multiplier and weight decay against
    JAX's `param_multipliers` and `decay_mask`: every conv trains at the
    base LR with weight decay, as in JAX (nothing is frozen: the stem is
    not ResNet's `conv1`); the BatchNorms, which JAX also trains, are no
    parameters of the port."""
    cfg = mobilenet_config()
    pcfg = to_port_cfg(cfg)
    model = build_model(pcfg, device="cpu")
    groups = {n: (g["lr_mult"], g["weight_decay"])
              for g in param_groups(model, pcfg) for n in g["names"]}
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = to_jax(sd, cfg)
    mults = _flat(param_multipliers(tree, cfg))
    decay = _flat(decay_mask(tree, cfg))
    names = [n for n, _ in model.named_parameters()
             if n.startswith("mobilenet.")]
    assert len(names) == 27
    for name in names:
        one = {k: np.zeros_like(v) for k, v in sd.items()}
        one[name] = np.ones_like(sd[name])
        leaf, = [k for k, v in _flat(mobilenet_to_jax(one)).items()
                 if np.any(v)]
        leaf = "['backbone']" + leaf
        want = (mults[leaf], cfg.train.weight_decay if decay[leaf] else 0.0)
        assert groups[name] == want == (1.0, cfg.train.weight_decay), name
    bn = [k for k in mults if "_bn'" in k]
    assert len(bn) == 4 * 27 and all(mults[k] == 1.0 for k in bn)


def test_mobilenet_caption_loss_matches_jax():
    """`cycle_response` on MobileNetV1: JAX's captioner takes its input
    width from the features, 2 x 1024 (it ignores the config's widths);
    the port's, sized by the config set to 2048, matches it: every loss,
    `loss_caption` included, within 1e-4 relative on the same weights
    (the port's init carried to JAX), with dropout off in both."""
    cfg = mobilenet_config(use_caption_loss=True, cap_drop_prob_lm=0.0,
                           cap_vocab_size=100, cap_rnn_size=64,
                           cap_input_encoding_size=64, cap_att_hid_size=64,
                           cap_fc_feat_size=2048, cap_att_feat_size=2048)
    cfg.train.lang_lr_mult = 1.0
    pcfg = to_port_cfg(cfg)
    sd = init_params(pcfg, 3)
    assert tuple(sd["caption_model.fc_embed.0.weight"].shape) == (64, 2048)
    assert tuple(sd["caption_model.att_embed.0.weight"].shape) == (64, 2048)
    model = build_model(pcfg, device="cpu", state_dict=sd)
    params = to_jax({k: v.numpy() for k, v in sd.items()}, cfg)
    batch = jsynthetic_batch(cfg, 2, 4, seed=5)
    assert "cap_labels" in batch
    targets = _targets(cfg, batch, seed=6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        _, j_losses = jax.jit(_jax_loss_fn(create_model(cfg), jbatch,
                                           _jax_targets(*targets)))(params)
    model.train()
    with torch.no_grad():
        losses = model.train_forward(to_device(batch, "cpu"), targets,
                                     torch.Generator().manual_seed(0))
    assert "loss_caption" in losses
    for k, v in j_losses.items():
        assert _rel(float(losses[k]), float(v)) <= 1e-4, \
            (k, float(losses[k]), float(v))


def test_mobilenet_caption_width_must_match_config():
    """With the config's ResNet widths (4096) the MobileNetV1 network
    builds, and its caption loss raises naming the keys and the 2048 the
    features have."""
    jcfg = mobilenet_config(use_caption_loss=True, cap_vocab_size=100,
                            cap_rnn_size=64, cap_input_encoding_size=64,
                            cap_att_hid_size=64)
    cfg = to_port_cfg(jcfg)
    assert cfg.model.cap_fc_feat_size == 4096
    model = build_model(cfg, device="cpu", seed=0).train()
    batch = jsynthetic_batch(jcfg, 1, 2, seed=5)
    targets = _targets(jcfg, batch, seed=6)
    with pytest.raises(ValueError, match="cap_fc_feat_size.*set both to "
                                         "2048"):
        with torch.no_grad():
            model.train_forward(to_device(batch, "cpu"), targets,
                                torch.Generator().manual_seed(0))
