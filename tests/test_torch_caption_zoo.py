"""The port's caption-zoo decoders (`show_tell`, `fc`, `topdown`,
`show_attend_tell`, `adaatt`) against the JAX package's, at small widths
(rnn, word encoding and attention hidden 32, vocab 16, 6 words, features
48): teacher-forced log-probs and NLL in train and eval mode, the NLL's
gradients, the weights (init shapes, the bridge both ways), the SGD
groups, three Adam steps against optax.adam, the factory's names, the
dropout of `show_tell` / `fc`, and a `cycle_response` network with the
`topdown` decoder.

Weights are the port's `init_captioner_params`, carried to JAX by
`tests/test_torch_weights.py::zoo_captioner_to_jax`. Dropout is off where
the packages are compared (jax.random bits cannot be reproduced in
torch); the port's dropout is checked by its statistics."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lang2seg_tpu.cli.variants import apply_variant
from lang2seg_tpu.engine.optimizer import decay_mask, param_multipliers
from lang2seg_tpu.models.caption_zoo import setup_captioner as jsetup
from lang2seg_tpu_torch.engine.optimizer import param_groups
from lang2seg_tpu_torch.engine.train_captioner import (
    captioner_train_step, init_captioner_state, run_captioner_training,
    validation_nll)
from lang2seg_tpu_torch.models.caption_zoo import setup_captioner
from lang2seg_tpu_torch.models.network import build_model
from lang2seg_tpu_torch.weights import (captioner_from_jax, from_jax_params,
                                        init_captioner_params, init_params,
                                        state_dict_shapes)
from tests.test_network import tiny_config
from tests.test_torch_captioner import (B, FEAT, L, T, _t, cap_config,
                                        caption_inputs)
from tests.test_torch_weights import (_flat, to_jax_tree, to_port_cfg,
                                      zoo_captioner_to_jax)

ZOO = ("show_tell", "fc", "topdown", "show_attend_tell", "adaatt")
# raw params and Dense layers of each JAX decoder
N_LEAVES = {"show_tell": 9, "fc": 9, "topdown": 18, "show_attend_tell": 12,
            "adaatt": 17}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host and slows
    every worker, the wall-clock tests among them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def shared_zoo(name, seed=0, **model_kw):
    """(port decoder on the CPU in eval mode, JAX decoder, JAX params)
    with the same weights."""
    cfg = cap_config(caption_model=name, **model_kw)
    sd = init_captioner_params(to_port_cfg(cfg), seed)
    cap = setup_captioner(to_port_cfg(cfg).model)
    cap.load_state_dict({k[len("caption_model."):]: v for k, v in sd.items()})
    params = jax.tree_util.tree_map(jnp.asarray, zoo_captioner_to_jax(
        {k: v.numpy() for k, v in sd.items()}))
    return cap.eval(), jsetup(cfg.model), params


def _jax_nll(jcap, params, fc, att, seq, mask, train):
    return jcap.apply({"params": params}, fc, att, seq, mask, train,
                      rngs={"dropout": jax.random.PRNGKey(0)},
                      method=type(jcap).teacher_forced_nll)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_logprobs_and_nll_match_jax(name, train):
    """Log-probs (B, T-1, V+1) and the masked-mean NLL within 2e-5 abs
    (f32) in eval mode and in train mode (dropout 0)."""
    cap, jcap, params = shared_zoo(name, seed=ZOO.index(name))
    fc, att, seq, mask = caption_inputs(seed=2)
    want = np.asarray(jcap.apply(
        {"params": params}, fc, att, seq, train,
        rngs={"dropout": jax.random.PRNGKey(0)},
        method=type(jcap).teacher_forced_logprobs))
    cap.train(train)
    with torch.no_grad():
        got = cap.teacher_forced_logprobs(*_t(fc, att, seq)).numpy()
        got_nll = float(cap.teacher_forced_nll(*_t(fc, att, seq, mask)))
    assert got.shape == want.shape == (B, T - 1, 17)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    want_nll = float(_jax_nll(jcap, params, fc, att, seq, mask, train))
    assert abs(got_nll - want_nll) <= 2e-5
    assert abs(want_nll - np.log(17)) < 1.0      # near uniform at init


@pytest.mark.parametrize("name", ZOO)
def test_zoo_nll_gradients_match_jax(name):
    """The NLL's gradient of every decoder parameter against jax.grad:
    within 1e-4 of the leaf's max |grad| (f32). Every leaf has a nonzero
    gradient (the decoders read every parameter)."""
    cap, jcap, params = shared_zoo(name, seed=10 + ZOO.index(name))
    fc, att, seq, mask = caption_inputs(seed=3)
    want = jax.grad(lambda p: _jax_nll(jcap, p, fc, att, seq, mask,
                                       False))(params)
    cap.teacher_forced_nll(*_t(fc, att, seq, mask)).backward()
    got = zoo_captioner_to_jax({"caption_model." + n: p.grad.numpy()
                                for n, p in cap.named_parameters()})
    flat_w, flat_g = _flat(want), _flat(got)
    assert set(flat_w) == set(flat_g) and len(flat_w) == N_LEAVES[name]
    for key, w in flat_w.items():
        w, g = np.asarray(w), np.asarray(flat_g[key])
        scale = np.abs(w).max()
        assert scale > 0, key
        assert np.abs(g - w).max() <= 1e-4 * scale, key


@pytest.mark.parametrize("name", ZOO)
def test_zoo_weights_bridge(name):
    """init_captioner_params gives the JAX decoder's params, shape for
    shape; captioner_from_jax and the test's converter invert each other
    bit for bit; the draws follow the flax init (normal(0.01) word
    embedding, lecun-normal raw matrices by their first axis, zero
    biases)."""
    cfg = cap_config(caption_model=name)
    pcfg = to_port_cfg(cfg)
    sd = init_captioner_params(pcfg, 0)
    jcap = jsetup(cfg.model)
    fc, att, seq, mask = caption_inputs()
    jshapes = jax.eval_shape(
        lambda k: jcap.init({"params": k}, fc, att, seq, mask, False,
                            method=type(jcap).teacher_forced_nll),
        jax.random.PRNGKey(0))["params"]
    want = {k: tuple(v.shape) for k, v in _flat(jshapes).items()}
    tree = zoo_captioner_to_jax({k: v.numpy() for k, v in sd.items()})
    assert {k: tuple(np.shape(v)) for k, v in _flat(tree).items()} == want
    back = captioner_from_jax(tree)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    assert abs(float(sd["caption_model.embed_w"].std()) - 0.01) < 1e-3
    w = sd["caption_model.logit_w"]                         # (32, 17)
    assert abs(float(w.std()) - 32 ** -0.5) < 0.15 * 32 ** -0.5
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("b", "bias") or leaf.endswith("_b"):
            assert not v.any(), k


@pytest.mark.parametrize("double_bias", [False, True])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_sgd_groups_match_jax(name, double_bias):
    """Each decoder parameter's LR multiplier and weight decay in a
    `cycle_response` network against the JAX package's `param_multipliers`
    and `decay_mask`: raw `*_b` / `b` params are weights there, the Dense
    biases biases."""
    cfg = apply_variant(tiny_config(), "cycle_response")
    for k, v in dict(caption_model=name, vocab_size=17, cap_rnn_size=32,
                     cap_input_encoding_size=32, cap_att_hid_size=32,
                     cap_vocab_size=16, cap_seq_length=6).items():
        setattr(cfg.model, k, v)
    cfg.train.double_bias = double_bias
    cfg.train.lang_lr_mult = 10.0
    pcfg = to_port_cfg(cfg)
    model = build_model(pcfg, device="cpu")
    groups = {n: (g["lr_mult"], g["weight_decay"])
              for g in param_groups(model, pcfg) for n in g["names"]}
    tree = zoo_captioner_to_jax({k: v.numpy()
                                 for k, v in model.state_dict().items()})
    mults = _flat(param_multipliers({"captioner": tree}, cfg))
    decay = _flat(decay_mask({"captioner": tree}, cfg))
    names = [n for n in groups if n.startswith("caption_model.")]
    assert len(names) == N_LEAVES[name]
    for n in names:
        rest = n[len("caption_model."):]
        if "." in rest:
            layer, leaf = rest.split(".")
            key = f"['captioner']['{layer}']['" + \
                ("kernel" if leaf == "weight" else "bias") + "']"
        else:
            key = f"['captioner']['{rest}']"
        want = (mults[key], cfg.train.weight_decay if decay[key] else 0.0)
        assert groups[n] == want, (n, groups[n], want)
    assert groups["caption_model.logit_b"] == (1.0, 1e-4)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_adam_steps_match_optax(name):
    """Three pretraining steps (`captioner_train_step`, Adam 5e-4) against
    optax.adam on jax.grad of the JAX decoder's NLL: every parameter
    within 2e-6 abs; validation_nll in eval mode equals the JAX eval NLL
    within 2e-5."""
    cfg = cap_config(caption_model=name)
    pcfg = to_port_cfg(cfg)
    state = init_captioner_state(pcfg, device="cpu", seed=3)
    jcap = jsetup(cfg.model)
    params = jax.tree_util.tree_map(jnp.asarray, zoo_captioner_to_jax(
        {"caption_model." + k: v.detach().numpy()
         for k, v in state.captioner.state_dict().items()}))
    tx = optax.adam(5e-4)
    opt = tx.init(params)
    for i in range(3):
        fc, att, seq, mask = caption_inputs(seed=20 + i)
        loss = captioner_train_step(state, *_t(fc, att, seq, mask))
        jloss, grads = jax.value_and_grad(
            lambda p: _jax_nll(jcap, p, fc, att, seq, mask, True))(params)
        upd, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, upd)
        assert abs(float(loss) - float(jloss)) <= 2e-5
    got = _flat(zoo_captioner_to_jax(
        {"caption_model." + k: v.detach().numpy()
         for k, v in state.captioner.state_dict().items()}))
    for key, w in _flat(params).items():
        np.testing.assert_allclose(got[key], np.asarray(w), rtol=0,
                                   atol=2e-6, err_msg=key)
    fc, att, seq, mask = caption_inputs(seed=30)
    want = float(_jax_nll(jcap, params, fc, att, seq, mask, False))
    assert abs(validation_nll(state.captioner, *_t(fc, att, seq, mask))
               - want) <= 2e-5
    assert state.captioner.training


def test_zoo_pretraining_loop():
    """run_captioner_training with the `topdown` decoder: finite losses,
    every parameter moves, and scheduled sampling (which no zoo decoder
    has) raises."""
    cfg = to_port_cfg(cap_config(caption_model="topdown"))
    batches = [tuple(_t(*caption_inputs(seed=s))) for s in range(3)]
    out = run_captioner_training(cfg, iter(batches), 3, device="cpu",
                                 val_iter=iter(batches), val_every=3)
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert np.isfinite(out["best_val"])
    fresh = init_captioner_params(cfg, 0)
    for k, v in out["state"].captioner.state_dict().items():
        assert not torch.equal(v, fresh["caption_model." + k]), k
    with pytest.raises(ValueError, match="scheduled sampling"):
        captioner_train_step(out["state"], *batches[0], ss_prob=0.25)


@pytest.mark.parametrize("name", ["show_tell", "fc"])
def test_zoo_dropout(name):
    """show_tell / fc in train mode draw their dropout from the caller's
    generator: the same seed gives the same log-probs, another seed
    others; a kept word embedding is scaled by 1 / (1 - p), about 1 - p
    of it kept; train mode with dropout and no generator raises; eval
    mode draws nothing. The attention decoders have no dropout (as in
    JAX): train mode with a generator equals eval mode."""
    cap, _, _ = shared_zoo(name, cap_drop_prob_lm=0.5)
    fc, att, seq, _ = _t(*caption_inputs())
    cap.train()
    a = cap.teacher_forced_logprobs(fc, att, seq,
                                    torch.Generator().manual_seed(0))
    b = cap.teacher_forced_logprobs(fc, att, seq,
                                    torch.Generator().manual_seed(0))
    c = cap.teacher_forced_logprobs(fc, att, seq,
                                    torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        cap.teacher_forced_logprobs(fc, att, seq)
    x = torch.ones(4000, 32)
    kept = cap._drop(x, torch.Generator().manual_seed(2))
    assert abs(float((kept != 0).float().mean()) - 0.5) < 0.03
    assert set(torch.unique(kept).tolist()) == {0.0, 2.0}
    cap.eval()
    e1 = cap.teacher_forced_logprobs(fc, att, seq)
    assert not torch.equal(a, e1)
    topdown, _, _ = shared_zoo("topdown", cap_drop_prob_lm=0.5)
    want = topdown.teacher_forced_logprobs(fc, att, seq)
    got = topdown.train().teacher_forced_logprobs(
        fc, att, seq, torch.Generator().manual_seed(0))
    assert torch.equal(got, want)


def test_setup_captioner_names():
    """Every JAX zoo name (aliases too) builds its decoder class, with the
    config's widths; an unknown name raises ValueError."""
    m = to_port_cfg(cap_config()).model
    for name, cls in (("show_tell", "ShowTellCaptioner"),
                      ("fc", "FCCaptioner"), ("topdown", "TopDownCaptioner"),
                      ("show_attend_tell", "ShowAttendTellCaptioner"),
                      ("all_img", "ShowAttendTellCaptioner"),
                      ("adaatt", "AdaAttCaptioner"),
                      ("adaattmo", "AdaAttCaptioner")):
        m.caption_model = name
        cap = setup_captioner(m)
        assert type(cap).__name__ == cls
        assert tuple(cap.embed_w.shape) == (17, 32)
        assert not hasattr(cap, "sample_beam")
    m.caption_model = "nope"
    with pytest.raises(ValueError):
        setup_captioner(m)


def test_cycle_response_with_topdown_matches_jax():
    """A `cycle_response` network with the `topdown` decoder: the state_dict
    maps onto the JAX tree, and train_forward's losses (loss_caption
    among them) match JAX's within 1e-4 relative on the same weights,
    batch and injected targets."""
    from lang2seg_tpu.data.synthetic import synthetic_batch
    from lang2seg_tpu_torch.engine.train_state import to_device
    from tests.test_torch_cycle import cycle_config
    from tests.test_torch_train import _jax_loss_fn, _jax_targets, _rel, \
        _targets
    from tests.test_torch_weights import _jax_param_shapes, shared_weights
    cfg = cycle_config("cycle_response", caption_model="topdown")
    sd = init_params(to_port_cfg(cfg), 0)
    tree = to_jax_tree({k: v.numpy() for k, v in sd.items()}, cfg)
    assert {k: tuple(np.shape(v)) for k, v in _flat(tree).items()} == \
        _jax_param_shapes(cfg)
    back = from_jax_params(tree, cfg)
    assert {k: tuple(v.shape) for k, v in back.items()} == \
        state_dict_shapes(to_port_cfg(cfg))
    model, jmodel, params = shared_weights(cfg, seed=4)
    batch = synthetic_batch(cfg, 2, 4, seed=5)
    targets = _targets(cfg, batch, seed=6)
    with jax.default_matmul_precision("float32"):
        _, j_losses = _jax_loss_fn(jmodel, {k: jnp.asarray(v) for k, v in
                                            batch.items()},
                                   _jax_targets(*targets))(params)
    model.train()
    with torch.no_grad():
        losses = model.train_forward(to_device(batch, "cpu"), targets)
    assert set(losses) == set(j_losses)
    for k in losses:
        assert _rel(float(losses[k]), float(j_losses[k])) <= 1e-4, k
    assert float(losses["loss_caption"]) > 1.0
