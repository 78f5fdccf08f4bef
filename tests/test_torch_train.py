"""The port's training slice against the JAX package's, at the tiny test
config with the `response` variant's conditioning (resnet26, 128x192, f32
compute, 7 filters, sigmoid gate, response loss): `Lang2Seg.
train_forward` losses and their gradients with injected targets, the
per-group SGD step with clipping, and `train_step` as a whole, on the
same weights (the port's init carried to JAX) and the same batch. Also:
word dropout, the synthetic batches and their wire formats, the entry
points' refusal of a missing card, and the Trainer loop.

Word dropout is off in the comparisons (jax.random bits cannot be
reproduced in torch); the samplers are held against JAX given the same
draws in tests/test_torch_targets.py."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lang2seg_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from lang2seg_tpu.engine.convert import convert_torch_state_dict
from lang2seg_tpu.engine.optimizer import (build_optimizer as jbuild_optimizer,
                                           merge_params, partition_params)
from lang2seg_tpu.models.network import Lang2Seg as JaxLang2Seg
from lang2seg_tpu.ops.targets import AnchorTargets as JAnchorTargets
from lang2seg_tpu.ops.targets import ProposalTargets as JProposalTargets
from lang2seg_tpu_torch.data.synthetic import (FixedBatchLoader,
                                              synthetic_batch, to_wire)
from lang2seg_tpu_torch.engine.optimizer import lr_schedule
from lang2seg_tpu_torch.engine.train_state import (apply_update,
                                                   create_train_state,
                                                   to_device, train_step)
from lang2seg_tpu_torch.engine.trainer import Trainer
from lang2seg_tpu_torch.models.lang_encoder import word_dropout
from lang2seg_tpu_torch.models.network import unpack_mask_bits
from lang2seg_tpu_torch.ops.anchors import shifted_anchors
from lang2seg_tpu_torch.ops.targets import anchor_targets, proposal_targets
from tests.test_torch_weights import (_flat, response_config, shared_weights,
                                      to_port_cfg)

LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box",
          "loss_mask", "loss_response", "total_loss")


def train_config(**train_kw):
    cfg = response_config(word_drop_out=0.0)
    for k, v in train_kw.items():
        setattr(cfg.train, k, v)
    return cfg


def _targets(cfg, batch, seed):
    """Anchor and ROI targets for a synthetic batch, from the port's
    samplers on jittered GT rois (so that fg slots exist)."""
    m, t = cfg.model, cfg.train
    g = torch.Generator().manual_seed(seed)
    e = batch["img_idx"].shape[0]
    gt = torch.from_numpy(batch["gt_boxes"])[:, None]
    valid = torch.ones((e, 1), dtype=torch.bool)
    im_hw = torch.from_numpy(batch["im_hw"][batch["img_idx"]])
    anchors = shifted_anchors(cfg.data.canvas_h // 16, cfg.data.canvas_w // 16,
                              16, m.anchor_scales, m.anchor_ratios)
    at = anchor_targets(anchors, gt, valid, im_hw[:, 0], im_hw[:, 1],
                        generator=g, rpn_batchsize=t.rpn_batchsize)
    p = 64
    rois = gt[:, :, :4] + torch.randn((e, p, 4), generator=g) * 6.0
    rois = torch.clamp(rois, min=0.0)
    rois[..., 2:] = torch.maximum(rois[..., 2:], rois[..., :2] + 4.0)
    pt = proposal_targets(rois, torch.ones((e, p), dtype=torch.bool), gt,
                          valid, torch.from_numpy(batch["gt_masks"])[:, None],
                          generator=g, num_rois=t.roi_batch_size,
                          mask_size=m.mask_size)
    return at, pt


def _jax_targets(at, pt):
    return (JAnchorTargets(*(jnp.asarray(x.numpy()) for x in at)),
            JProposalTargets(*(jnp.asarray(x.numpy()) for x in pt)))


def _jax_loss_fn(jmodel, batch, targets):
    def loss_fn(params):
        losses = jmodel.apply(
            {"params": params}, batch, targets,
            rngs={"dropout": jax.random.PRNGKey(0),
                  "sampling": jax.random.PRNGKey(1)},
            method=JaxLang2Seg.train_forward)
        return losses["total_loss"], losses
    return loss_fn


@pytest.fixture(scope="module")
def slice_setup():
    """Shared weights, a 2-image x 4-expression batch, injected targets,
    and the JAX losses and gradients on them (one eager JAX run)."""
    cfg = train_config(learning_rate=1e-3)
    model, jmodel, params = shared_weights(cfg, seed=4)
    batch = jsynthetic_batch(cfg, 2, 4, seed=5)
    at, pt = _targets(cfg, batch, seed=6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        (_, j_losses), j_grads = jax.value_and_grad(
            _jax_loss_fn(jmodel, jbatch, _jax_targets(at, pt)),
            has_aux=True)(params)
    return (cfg, model, jmodel, params, batch, (at, pt),
            {k: float(v) for k, v in j_losses.items()}, j_grads)


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


@pytest.mark.parametrize("wire", ["float32", "uint8_packed"])
def test_train_forward_losses_match_jax(slice_setup, wire):
    """Every loss within 1e-4 relative, on the f32 canvas with raw masks
    and on the wire formats of the flagship config (uint8 canvas, masks
    bit-packed along the width), which both packages decode on device."""
    cfg, model, jmodel, params, batch, targets, j_losses, _ = slice_setup
    if wire == "uint8_packed":
        batch = to_wire(to_port_cfg(cfg), batch)
        assert batch["images"].dtype == np.uint8
        assert batch["gt_masks"].shape[-1] == cfg.data.canvas_w // 8
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


def _port_grads_as_jax_tree(model, cfg):
    sd = {k: np.zeros(v.shape, np.float32)
          for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        if p.grad is not None:
            sd[name] = p.grad.detach().numpy()
    return convert_torch_state_dict(sd, cfg)


def test_train_forward_gradients_match_jax(slice_setup):
    """The whole backward (losses, heads, ROI crop, RPN, the gate's
    autograd Function with its plain backward, the encoder, the gathered
    backbone map) against jax.grad: each trainable leaf within 1e-4 in
    relative L2 norm (f32 convolutions and reductions summed in another
    order through ~40 layers; ~7e-6 at worst when written); frozen leaves
    get no gradient."""
    cfg, model, _, params, batch, targets, _, j_grads = slice_setup
    model.train()
    model.zero_grad(set_to_none=True)
    losses = model.train_forward(to_device(batch, "cpu"), targets)
    losses["total_loss"].backward()
    model.eval()
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert {n.split(".")[1] for n in frozen} == {"conv1", "layer1"}
    assert all(model.get_parameter(n).grad is None for n in frozen)
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
    assert checked >= 40
    for name in ("dynamic_fc_3.weight", "response_fc.weight",
                 "rnn_encoder.embedding.weight",
                 "resnet.layer2.0.conv1.weight"):
        assert float(model.get_parameter(name).grad.abs().max()) > 0, name


def _random_grads(model, rng, scale):
    return {n: torch.from_numpy((rng.randn(*p.shape) * scale).astype(
        np.float32)) for n, p in model.named_parameters() if p.requires_grad}


def test_sgd_steps_match_jax_optimizer(rng):
    """Two steps of the port's SGD groups against the JAX chain
    (clip_by_global_norm at 10, decayed weights, momentum trace, group
    multipliers, piecewise LR with a boundary at step 1) on the same
    gradients: the first clipped (norm > 10), the second not. Updated
    parameters within 1e-5 relative; frozen ones bit-identical; the
    language groups move with 10x the LR."""
    cfg = train_config(learning_rate=1e-2, stepsize=(1,), gamma=0.5)
    pcfg = to_port_cfg(cfg)
    model, _, params = shared_weights(cfg, seed=1)
    state = create_train_state(pcfg, device="cpu",
                               state_dict=model.state_dict())
    model = state.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainable, frozen = partition_params(params, cfg)
    tx = jbuild_optimizer(trainable, cfg)
    opt_state = tx.init(trainable)
    assert [lr_schedule(pcfg, s) for s in (0, 1, 2)] == [1e-2, 5e-3, 5e-3]
    for step, scale in ((0, 1.0), (1, 1e-4)):
        grads = _random_grads(model, rng, scale)
        norm = float(torch.linalg.vector_norm(
            torch.stack([g.norm() for g in grads.values()])))
        assert (norm > 10.0) == (step == 0)
        # the port's update from these gradients
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = grads[n].clone().contiguous(
                    memory_format=torch.channels_last
                    if p.dim() == 4 else torch.contiguous_format)
        lang = model.get_parameter("rnn_encoder.mlp.0.weight")
        other = model.get_parameter("rpn_net.weight")
        w_lang, w_other = lang.detach().clone(), other.detach().clone()
        apply_update(state)
        g_lang, g_other = lang.grad, other.grad            # clipped in place
        if step == 0:
            # first step, zero momentum: delta = -lr * mult * (g + wd * w);
            # a difference of parameters carries their own rounding, about
            # 4e-9 at |w| ~ 0.05
            wd = cfg.train.weight_decay
            torch.testing.assert_close(
                lang.detach() - w_lang, -1e-1 * (g_lang + wd * w_lang),
                rtol=1e-3, atol=1e-8)
            torch.testing.assert_close(
                other.detach() - w_other, -1e-2 * (g_other + wd * w_other),
                rtol=1e-3, atol=1e-8)
        # the JAX chain on the same gradients
        sd = {k: np.zeros(v.shape, np.float32)
              for k, v in model.state_dict().items()}
        sd.update({n: g.numpy() for n, g in grads.items()})
        j_grads, _ = partition_params(convert_torch_state_dict(sd, cfg), cfg)
        updates, opt_state = tx.update(j_grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
    new = _flat(merge_params(trainable, frozen))
    got = _flat(convert_torch_state_dict(
        {k: v.detach().numpy() for k, v in model.state_dict().items()}, cfg))
    for key, w in new.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(w),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    trainable_names = {n for n, p in model.named_parameters()
                       if p.requires_grad}
    assert moved == trainable_names


def test_train_step_matches_jax_step(slice_setup):
    """The slice as a whole: `train_step` (forward, losses, backward through
    the gate Function, clipping at 10, per-group SGD) against JAX's loss
    gradients pushed through its optimizer chain. The updates agree within
    1e-4 in relative L2 norm per leaf (the gradients' tolerance)."""
    cfg, model, _, params, batch, targets, j_losses, j_grads = slice_setup
    # a large LR, so that the updates stand far above the parameters' own
    # f32 rounding in new - old (the losses and gradients do not depend on
    # it)
    cfg = copy.deepcopy(cfg)
    cfg.train.learning_rate = 1.0
    pcfg = to_port_cfg(cfg)
    state = create_train_state(pcfg, device="cpu",
                               state_dict=model.state_dict())
    old = _flat(params)
    losses = train_step(state, to_device(batch, "cpu"), None, targets)
    assert state.step == 1
    assert _rel(float(losses["total_loss"]), j_losses["total_loss"]) <= 1e-4
    trainable, frozen = partition_params(params, cfg)
    tx = jbuild_optimizer(trainable, cfg)
    g_tr, _ = partition_params(j_grads, cfg)
    updates, _ = tx.update(g_tr, tx.init(trainable), trainable)
    want = _flat(merge_params(optax.apply_updates(trainable, updates), frozen))
    got = _flat(convert_torch_state_dict(
        {k: v.detach().numpy() for k, v in state.model.state_dict().items()},
        cfg))
    checked = 0
    for key, w in want.items():
        d_w = np.asarray(w) - np.asarray(old[key])
        d_g = np.asarray(got[key]) - np.asarray(old[key])
        if not np.any(d_w):
            assert not np.any(d_g), key            # frozen
            continue
        assert np.linalg.norm(d_g - d_w) / np.linalg.norm(d_w) <= 1e-4, key
        checked += 1
    assert checked >= 40


def test_word_dropout():
    """flax nn.Dropout semantics: a fraction 1 - p kept, scaled by
    1 / (1 - p); the same generator state gives the same mask; off in
    eval; train mode without a generator raises."""
    x = torch.ones((64, 10, 512))
    g = torch.Generator().manual_seed(0)
    y = word_dropout(x, 0.5, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    y2 = word_dropout(x, 0.2, torch.Generator().manual_seed(0))
    assert abs(float((y2 != 0).float().mean()) - 0.8) < 0.01
    assert torch.allclose(y2[y2 != 0], torch.tensor(1.25))
    again = word_dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)

    cfg = to_port_cfg(response_config())          # word_drop_out 0.5
    enc = create_train_state(cfg, device="cpu").model.rnn_encoder
    labels = torch.randint(1, 100, (4, 10), generator=g)
    enc.eval()
    a, b = enc(labels)[1], enc(labels, torch.Generator().manual_seed(1))[1]
    assert torch.equal(a, b)
    enc.train()
    c = enc(labels, torch.Generator().manual_seed(1))[1]
    d = enc(labels, torch.Generator().manual_seed(1))[1]
    assert torch.equal(c, d) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        enc(labels)


def test_synthetic_batch_and_wire(rng):
    """The port's synthetic_batch draws what the JAX copy draws for the
    same seed; to_wire gives the flagship config's wire formats, which
    decode back to the same canvas and masks."""
    cfg = response_config()
    pcfg = to_port_cfg(cfg)
    for seed in (0, 3):
        want = jsynthetic_batch(cfg, 2, 5, seed=seed)
        got = synthetic_batch(pcfg, 2, 5, seed=seed)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    wire = to_wire(pcfg, got)
    assert pcfg.data.wire_uint8_images and pcfg.data.wire_packed_masks
    means = np.asarray(pcfg.data.pixel_means_bgr, np.float32)
    np.testing.assert_array_equal(
        wire["images"], np.clip(np.round(got["images"] + means), 0,
                                255).astype(np.uint8))
    np.testing.assert_array_equal(
        unpack_mask_bits(torch.from_numpy(wire["gt_masks"])).numpy(),
        got["gt_masks"])


def test_entry_points_refuse_missing_card(monkeypatch):
    cfg = to_port_cfg(train_config())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, [])
    state = create_train_state(cfg, device="cpu")
    assert state.model.training and state.step == 0


def test_trainer_steps_on_cpu(capsys):
    """Trainer over synthetic batches, with word dropout and the samplers
    drawing from its generator: finite losses, a display line per
    `display` steps, frozen parameters bit-identical, the rest moved."""
    cfg = to_port_cfg(response_config())
    cfg.train.display = 2
    batches = [to_wire(cfg, synthetic_batch(cfg, 2, 4, seed=s))
               for s in range(3)]
    tr = Trainer(cfg, FixedBatchLoader(batches), device="cpu")
    before = {n: p.detach().clone()
              for n, p in tr.state.model.named_parameters()}
    last = tr.train(3)
    assert tr.state.step == 3
    assert set(last) == set(LOSSES)
    assert all(np.isfinite(v) for v in last.values())
    out = capsys.readouterr().out
    assert "iter 2/3:" in out and "iter 3/3:" in out and "s/iter" in out
    for n, p in tr.state.model.named_parameters():
        same = torch.equal(before[n], p.detach())
        assert same != p.requires_grad, n


def test_clip_by_global_norm_accurate_on_large_tensors():
    """The global norm over VGG16-sized gradients (fc6 is 4096 x 25088):
    the port's clipping against optax.clip_by_global_norm and a float64
    norm, within 1e-6 relative. One f32 accumulation over a whole tensor
    (torch's CPU vector_norm) is off by ~1% at this size."""
    from lang2seg_tpu_torch.engine.optimizer import clip_by_global_norm_
    g = torch.Generator().manual_seed(0)
    grads = [torch.randn((4096, 25088), generator=g) * 1e-3,
             torch.randn((512, 256, 3, 3), generator=g) * 1e-2,
             torch.randn((4096,), generator=g)]
    want_norm = float(torch.sqrt(sum(torch.sum(x.double() ** 2)
                                     for x in grads)))
    clip = optax.clip_by_global_norm(10.0)
    jgrads = [jnp.asarray(x.numpy()) for x in grads]
    want, _ = clip.update(jgrads, clip.init(jgrads))
    got = [x.clone() for x in grads]
    norm = float(clip_by_global_norm_(got, 10.0))
    assert _rel(norm, want_norm) <= 1e-6
    assert _rel(float(torch.linalg.vector_norm(grads[0])),
                float(torch.linalg.vector_norm(grads[0].double()))) > 1e-4
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=1e-12)
