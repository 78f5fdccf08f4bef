"""The caption-consistency training path of the port (`cycle_response`,
`cycle`) against the JAX package, at the tiny test config (resnet26,
128x192, f32 compute) with a small captioner (rnn, word encoding and
attention hidden 32, vocab 16, 6 words; its features stay 2 x 2048):
`Lang2Seg.train_forward`'s losses, `loss_caption` among them, and the
gradients of `total_loss` with injected targets; the SGD groups of the
captioner and one SGD step; the weights bridge; `extract_caption_features`;
the synthetic caption fields; and the Trainer on the CPU.

Dropout (word and captioner) is off where the two packages are compared:
jax.random bits cannot be reproduced in torch."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lang2seg_tpu.cli.variants import apply_variant
from lang2seg_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from lang2seg_tpu.engine.convert import convert_torch_state_dict
from lang2seg_tpu.engine.optimizer import (build_optimizer as jbuild_optimizer,
                                           decay_mask, merge_params,
                                           param_multipliers, partition_params)
from lang2seg_tpu.engine.train_captioner import (
    extract_caption_features as jextract_caption_features)
from lang2seg_tpu_torch.data.synthetic import (FixedBatchLoader,
                                              synthetic_batch, to_wire)
from lang2seg_tpu_torch.engine.inference import Inference
from lang2seg_tpu_torch.engine.optimizer import param_groups
from lang2seg_tpu_torch.engine.train_captioner import extract_caption_features
from lang2seg_tpu_torch.engine.train_state import (create_train_state,
                                                   to_device, train_step)
from lang2seg_tpu_torch.engine.trainer import Trainer
from lang2seg_tpu_torch.models.network import build_model
from lang2seg_tpu_torch.weights import (from_jax_params, init_params,
                                        state_dict_shapes)
from tests.test_network import tiny_config
from tests.test_torch_train import (_jax_loss_fn, _jax_targets,
                                    _port_grads_as_jax_tree, _rel, _targets)
from tests.test_torch_weights import (_flat, _jax_param_shapes,
                                      shared_weights, to_port_cfg)

VARIANTS = ("cycle_response", "cycle")
LOSSES = {"cycle_response": ("rpn_cross_entropy", "rpn_loss_box",
                             "cross_entropy", "loss_box", "loss_mask",
                             "loss_response", "loss_caption", "total_loss"),
          "cycle": ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy",
                    "loss_box", "loss_mask", "loss_caption", "total_loss")}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host and slows
    every worker, the wall-clock tests among them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cycle_config(variant, **model_kw):
    """tiny_config under the variant's preset, with a small captioner;
    the expression vocabulary is the captioner's (16 words + index 0),
    so the synthetic captions are in its range."""
    cfg = apply_variant(tiny_config(), variant)
    kw = dict(vocab_size=17, word_drop_out=0.0, cap_rnn_size=32,
              cap_input_encoding_size=32, cap_att_hid_size=32,
              cap_vocab_size=16, cap_seq_length=6, cap_drop_prob_lm=0.0)
    kw.update(model_kw)
    for k, v in kw.items():
        setattr(cfg.model, k, v)
    return cfg


@pytest.fixture(scope="module", params=VARIANTS)
def cycle_setup(request):
    """Shared weights, a 2-image x 4-expression batch, injected targets,
    and the JAX losses and gradients on them (one eager JAX run)."""
    cfg = cycle_config(request.param)
    cfg.train.learning_rate = 1e-3
    model, jmodel, params = shared_weights(cfg, seed=4)
    batch = jsynthetic_batch(cfg, 2, 4, seed=5)
    targets = _targets(cfg, batch, seed=6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        (_, j_losses), j_grads = jax.value_and_grad(
            _jax_loss_fn(jmodel, jbatch, _jax_targets(*targets)),
            has_aux=True)(params)
    return (request.param, cfg, model, params, batch, targets,
            {k: float(v) for k, v in j_losses.items()}, j_grads)


def test_cycle_losses_match_jax(cycle_setup):
    """Every loss, loss_caption among them, within 1e-4 relative (as in
    tests/test_torch_train.py)."""
    variant, cfg, model, _, batch, targets, j_losses, _ = cycle_setup
    model.train()
    with torch.no_grad():
        losses = model.train_forward(to_device(batch, "cpu"), targets)
    model.eval()
    assert set(losses) == set(LOSSES[variant]) == set(j_losses)
    for k in LOSSES[variant]:
        assert _rel(float(losses[k]), j_losses[k]) <= 1e-4, \
            (k, float(losses[k]), j_losses[k])
    assert float(losses["loss_caption"]) > 1.0


def test_cycle_gradients_match_jax(cycle_setup):
    """The backward through both consumers of the gated map (the ROI crop
    and the caption branch's layer4 on the full map; for `cycle` the
    GT-masked copy instead) against jax.grad: each trainable leaf within
    1e-4 in relative L2 norm (tests/test_torch_train.py's tolerance).
    Two captioner leaves have no gradient to compare: the fc embed, which
    att2in2 computes but never reads (0 in both), and alpha_net's bias,
    which softmax makes 0 up to rounding (both below 1e-6)."""
    variant, cfg, model, params, batch, targets, _, j_grads = cycle_setup
    model.train()
    model.zero_grad(set_to_none=True)
    losses = model.train_forward(to_device(batch, "cpu"), targets)
    losses["total_loss"].backward()
    model.eval()
    got = _flat(_port_grads_as_jax_tree(model, cfg))
    want = _flat(j_grads)
    trainable, _ = partition_params(params, cfg)
    checked = set()
    for key, leaf in _flat(trainable).items():
        if leaf is None:
            continue
        w, g = np.asarray(want[key]), np.asarray(got[key])
        if key.startswith("['captioner']['fc_embed']"):
            assert not w.any() and not g.any(), key
            continue
        if key == "['captioner']['alpha_b']":
            assert np.abs(w).max() < 1e-6 and np.abs(g).max() < 1e-6
            continue
        denom = np.linalg.norm(w)
        assert denom > 0, key
        assert np.linalg.norm(g - w) / denom <= 1e-4, key
        checked.add(key.split("]")[0].strip("['"))
    assert {"captioner", "backbone", "filter_gen", "rpn_head",
            "encoder"} <= checked
    for name in ("caption_model.core.a2c.weight", "resnet.layer4.0.conv2.weight",
                 "dynamic_fc_3.weight", "response_fc.weight",
                 "rpn_net.weight"):
        assert float(model.get_parameter(name).grad.abs().max()) > 0, name


def test_cycle_train_step_matches_jax_step(cycle_setup):
    """`train_step` (forward, backward, clipping at 10, per-group SGD)
    against JAX's gradients through its optimizer chain: updates within
    1e-4 in relative L2 norm per leaf, captioner included."""
    variant, cfg, model, params, batch, targets, j_losses, j_grads = \
        cycle_setup
    cfg = copy.deepcopy(cfg)
    cfg.train.learning_rate = 1.0
    state = create_train_state(to_port_cfg(cfg), device="cpu",
                               state_dict=model.state_dict())
    old = _flat(params)
    losses = train_step(state, to_device(batch, "cpu"), None, targets)
    assert _rel(float(losses["total_loss"]), j_losses["total_loss"]) <= 1e-4
    trainable, frozen = partition_params(params, cfg)
    tx = jbuild_optimizer(trainable, cfg)
    g_tr, _ = partition_params(j_grads, cfg)
    updates, _ = tx.update(g_tr, tx.init(trainable), trainable)
    want = _flat(merge_params(optax.apply_updates(trainable, updates), frozen))
    got = _flat(convert_torch_state_dict(
        {k: v.detach().numpy() for k, v in state.model.state_dict().items()},
        cfg))
    cap_checked = 0
    for key, w in want.items():
        d_w = np.asarray(w) - np.asarray(old[key])
        d_g = np.asarray(got[key]) - np.asarray(old[key])
        if not np.any(d_w):
            assert not np.any(d_g), key
            continue
        if key == "['captioner']['alpha_b']":
            continue                 # a gradient of rounding noise only
        assert np.linalg.norm(d_g - d_w) / np.linalg.norm(d_w) <= 1e-4, key
        cap_checked += key.startswith("['captioner']")
    assert cap_checked >= 15


@pytest.mark.parametrize("double_bias", [False, True])
def test_captioner_sgd_groups_match_jax(double_bias):
    """Each captioner parameter's LR multiplier and weight decay against
    the JAX package's `param_multipliers` and `decay_mask`: the raw
    `*_b` params of the JAX tree (logit, i2h, h2h, a2c, h2att, alpha) are
    weights there (decayed, never doubled), the fc / att embed and
    ctx2att biases are biases; the captioner is neither frozen nor in
    the language group."""
    cfg = cycle_config("cycle_response")
    cfg.train.double_bias = double_bias
    cfg.train.lang_lr_mult = 10.0            # tells the language group apart
    pcfg = to_port_cfg(cfg)
    model = build_model(pcfg, device="cpu")
    groups = {n: (g["lr_mult"], g["weight_decay"])
              for g in param_groups(model, pcfg) for n in g["names"]}
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = convert_torch_state_dict(sd, cfg)
    mults = _flat(param_multipliers(tree, cfg))
    decay = _flat(decay_mask(tree, cfg))
    names = [n for n in groups if n.startswith("caption_model.")]
    assert len(names) == 19
    for name in names:
        one = {k: np.zeros_like(v) for k, v in sd.items()}
        one[name] = np.ones_like(sd[name])
        leaf, = [k for k, v in _flat(convert_torch_state_dict(one, cfg))
                 .items() if np.any(v)]
        want = (mults[leaf], cfg.train.weight_decay if decay[leaf] else 0.0)
        assert groups[name] == want, (name, leaf, groups[name], want)
    assert groups["caption_model.logit.bias"] == (1.0, 1e-4)
    assert groups["caption_model.ctx2att.bias"] == \
        (2.0 if double_bias else 1.0, 0.0)


def test_weights_bridge_with_captioner():
    """The port's cycle state_dict maps onto every JAX param (captioner
    included) with the right shapes, and from_jax_params inverts
    convert_torch_state_dict bit for bit."""
    cfg = cycle_config("cycle_response")
    pcfg = to_port_cfg(cfg)
    want_shapes = _jax_param_shapes(cfg)
    sd = init_params(pcfg, 0)
    tree = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                    cfg)
    got_shapes = {k: tuple(np.shape(v)) for k, v in _flat(tree).items()}
    assert got_shapes == want_shapes
    assert sum(k.startswith("['captioner']") for k in got_shapes) == 19
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


def test_extract_caption_features_match_jax():
    """The 'res5_2' pairing (the image map and its GT-masked copy through
    layer4 at full size): fc (E, 4096) and att (E, 196, 4096) within 1e-4
    of the max |value| (f32 through layer1..layer4), on raw and on
    bit-packed masks."""
    cfg = cycle_config("cycle")
    model, jmodel, params = shared_weights(cfg, seed=3)
    batch = jsynthetic_batch(cfg, 2, 3, seed=7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        wfc, watt = (np.asarray(a) for a in jextract_caption_features(
            jmodel, params, jb, cfg))
    packed = dict(batch, gt_masks=np.packbits(batch["gt_masks"] > 0, -1))
    for b in (batch, packed):
        fc, att = extract_caption_features(model, to_device(b, "cpu"))
        assert fc.shape == (3, 4096) and att.shape == (3, 196, 4096)
        assert fc.dtype == att.dtype == torch.float32
        for g, w in ((fc, wfc), (att, watt)):
            assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


@pytest.mark.parametrize("variant", VARIANTS)
def test_synthetic_caption_fields_match_jax(variant):
    """synthetic_batch's cap_labels and cap_masks are the JAX copy's draws
    for the same seed; to_device carries them to the model's device."""
    cfg = cycle_config(variant)
    want = jsynthetic_batch(cfg, 2, 5, seed=2)
    got = synthetic_batch(to_port_cfg(cfg), 2, 5, seed=2)
    assert {"cap_labels", "cap_masks"} <= set(got) and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    dev = to_device(got, "cpu")
    assert dev["cap_labels"].dtype == torch.int32
    assert dev["cap_masks"].dtype == torch.float32
    assert dev["cap_labels"].shape == (5, 8)


def test_trainer_cycle_response_on_cpu():
    """Trainer over cycle_response batches with word and captioner
    dropout on: finite losses with loss_caption, frozen parameters
    bit-identical, the captioner's parameters moved, but for the fc embed:
    att2in2 never reads it, and its weight decay alone (lr 1e-5 x 1e-4 x
    |w|) is below its f32 rounding."""
    cfg = to_port_cfg(cycle_config("cycle_response", word_drop_out=0.5,
                                   cap_drop_prob_lm=0.5))
    cfg.train.display = 1
    batches = [to_wire(cfg, synthetic_batch(cfg, 2, 4, seed=s))
               for s in range(2)]
    tr = Trainer(cfg, FixedBatchLoader(batches), device="cpu")
    before = {n: p.detach().clone()
              for n, p in tr.state.model.named_parameters()}
    last = tr.train(2)
    assert set(last) == set(LOSSES["cycle_response"])
    assert all(np.isfinite(v) for v in last.values())
    for n, p in tr.state.model.named_parameters():
        same = torch.equal(before[n], p.detach())
        if not p.requires_grad:
            assert same, n
        elif n.startswith("caption_model.") and \
                not n.startswith("caption_model.fc_embed."):
            assert not same, n


def test_cycle_model_serves_like_response():
    """A cycle model serves through Inference: its captioner takes no part
    in test_forward."""
    cfg = to_port_cfg(cycle_config("cycle"))
    model = build_model(cfg, device="cpu", seed=1)
    b = synthetic_batch(cfg, 1, 3, seed=4)
    out = Inference(model, cfg, device="cpu").predict(
        b["images"], b["im_hw"], b["labels"])
    r = cfg.test.rpn_post_nms_top_n
    assert out["rois"].shape == (3, r, 4)
    assert out["gated_conv"].shape == (3, 8, 12, 1024)
    assert all(bool(torch.isfinite(v.float()).all()) for v in out.values())
