"""The port's att2in2 captioner and its pretraining against the JAX
package, at small widths (rnn, word encoding and attention hidden 32,
vocab 16, 6 words, features 48): teacher-forced log-probs, the NLL and
its gradients, greedy and beam decodes, `_adaptive_pool`, three Adam
steps against optax.adam, scheduled sampling's schedule, the caption
framing of the loader, `restore_captioner` and the pretraining loop.

Weights are the port's `init_captioner_params`, carried to JAX by its
`engine/convert.py::convert_captioner`. Dropout is off where the two
packages are compared (jax.random bits cannot be reproduced in torch);
the port's dropout and scheduled sampling are checked on their own."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lang2seg_tpu.data.loader import GtBatchLoader
from lang2seg_tpu.engine.convert import convert_captioner
from lang2seg_tpu.engine.train_captioner import (
    CaptionerTrainState as JCaptionerTrainState, make_captioner_train_step,
    scheduled_sampling_prob as jscheduled_sampling_prob)
from lang2seg_tpu.models.caption_zoo import setup_captioner as jsetup
from lang2seg_tpu.models.captioner import Att2In2Captioner as JCaptioner
from lang2seg_tpu.models.network import _adaptive_pool as j_adaptive_pool
from lang2seg_tpu_torch.data.loader import caption_targets
from lang2seg_tpu_torch.engine.train_captioner import (
    captioner_state_dict, captioner_train_step, init_captioner_state,
    restore_captioner, run_captioner_training, scheduled_sampling_prob)
from lang2seg_tpu_torch.models.caption_zoo import setup_captioner
from lang2seg_tpu_torch.models.captioner import Att2In2Captioner
from lang2seg_tpu_torch.models.network import _adaptive_pool
from lang2seg_tpu_torch.weights import init_captioner_params
from tests.test_network import tiny_config
from tests.test_torch_weights import to_port_cfg

FEAT = 48
EOS_BIAS = 0.6
B, L, T = 5, 12, 8            # rows, attention positions, caption columns


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host and slows
    every worker, the wall-clock tests among them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cap_config(**model_kw):
    kw = dict(use_caption_loss=True, cap_rnn_size=32,
              cap_input_encoding_size=32, cap_att_hid_size=32,
              cap_vocab_size=16, cap_seq_length=6, cap_fc_feat_size=FEAT,
              cap_att_feat_size=FEAT, cap_drop_prob_lm=0.0)
    kw.update(model_kw)
    return tiny_config(**kw)


def shared_captioner(cfg, seed=0):
    """(port captioner on the CPU in eval mode, JAX captioner, JAX params)
    with the same weights."""
    sd = init_captioner_params(to_port_cfg(cfg), seed)
    cap = setup_captioner(to_port_cfg(cfg).model)
    cap.load_state_dict({k[len("caption_model."):]: v for k, v in sd.items()})
    params = jax.tree_util.tree_map(jnp.asarray, convert_captioner(
        {k: v.numpy() for k, v in sd.items()}))
    return cap.eval(), jsetup(cfg.model), params


def caption_inputs(seed=0):
    """Features and a BOS/EOS-framed caption batch of varying lengths."""
    r = np.random.RandomState(seed)
    fc = r.randn(B, FEAT).astype(np.float32)
    att = r.randn(B, L, FEAT).astype(np.float32)
    labels = r.randint(1, 17, (B, T - 2)).astype(np.int32)
    for i, n in enumerate(r.randint(1, T - 1, B)):
        labels[i, n:] = 0
    tg = caption_targets(labels)
    return fc, att, tg["cap_labels"], tg["cap_masks"]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_grad_tree_of(cap):
    """The port's gradients as a JAX tree; a parameter the loss does not
    reach (att2in2 embeds its fc features but never reads them) as 0."""
    return convert_captioner({
        "caption_model." + n: (np.zeros(p.shape, np.float32) if p.grad is None
                               else p.grad.numpy())
        for n, p in cap.named_parameters()})


def test_teacher_forced_logprobs_and_nll_match_jax():
    """Log-probs (B, T-1, V+1) and the masked-mean NLL within 1e-5 abs
    (f32; the same sums in another order)."""
    cfg = cap_config()
    cap, jcap, params = shared_captioner(cfg)
    fc, att, seq, mask = caption_inputs()
    want = np.asarray(jcap.apply({"params": params}, fc, att, seq, False,
                                 method=JCaptioner.teacher_forced_logprobs))
    with torch.no_grad():
        got = cap.teacher_forced_logprobs(*_t(fc, att, seq)).numpy()
    assert got.shape == want.shape == (B, T - 1, 17)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want_nll = float(jcap.apply({"params": params}, fc, att, seq, mask,
                                False, method=JCaptioner.teacher_forced_nll))
    with torch.no_grad():
        got_nll = float(cap.teacher_forced_nll(*_t(fc, att, seq, mask)))
    assert abs(got_nll - want_nll) <= 1e-5
    assert abs(want_nll - np.log(17)) < 1.0      # near uniform at init


def test_nll_gradients_match_jax():
    """The NLL's gradient for every captioner parameter against jax.grad:
    within 1e-5 of the leaf's max |grad| (f32). alpha_net's bias shifts
    every attention logit alike, so softmax makes its gradient 0 up to
    rounding: both are held below 1e-6 instead. The fc embed is computed
    but unused by att2in2: no gradient in either."""
    cfg = cap_config()
    cap, jcap, params = shared_captioner(cfg, seed=1)
    fc, att, seq, mask = caption_inputs(seed=1)
    want = jax.grad(lambda p: jcap.apply(
        {"params": p}, fc, att, seq, mask, False,
        method=JCaptioner.teacher_forced_nll))(params)
    cap.teacher_forced_nll(*_t(fc, att, seq, mask)).backward()
    got = _jax_grad_tree_of(cap)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g) == 19
    for path, w in flat_w:
        w, g = np.asarray(w), np.asarray(flat_g[path])
        key = jax.tree_util.keystr(path)
        if key == "['alpha_b']":
            assert np.abs(w).max() < 1e-6 and np.abs(g).max() < 1e-6
            continue
        if key.startswith("['fc_embed']"):
            assert not w.any() and not g.any(), key
            continue
        scale = np.abs(w).max()
        assert scale > 0, key
        assert np.abs(g - w).max() <= 1e-5 * scale, key


def test_sample_greedy_matches_jax():
    """The same tokens, the chosen words' log-probs within 1e-5; a row is
    PAD from its first EOS on."""
    cfg = cap_config()
    cap, jcap, params = shared_captioner(cfg, seed=6)
    # logit weights x 4 (confident, varied words) and EOS made likelier,
    # so that some rows end early
    params["logit_w"] = params["logit_w"] * 4.0
    params["logit_b"] = params["logit_b"].at[0].set(EOS_BIAS)
    with torch.no_grad():
        cap.logit.weight.mul_(4.0)
        cap.logit.bias[0] = EOS_BIAS
    fc, att, _, _ = caption_inputs(seed=6)
    jseq, jlp = jcap.apply({"params": params}, fc, att,
                           method=JCaptioner.sample_greedy)
    seq, lp = cap.sample_greedy(*_t(fc, att))
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0,
                               atol=1e-5)
    assert seq.shape == (B, 6)
    ended = 0
    for row in seq.numpy():
        z = np.flatnonzero(row == 0)
        if z.size:
            assert not row[z[0]:].any()
            ended += int(z[0] > 0)
    assert 0 < ended < B


@pytest.mark.parametrize("seed", [3, 4])
def test_sample_beam_matches_jax(seed):
    """Beam 3: the same best sequences, scores within 1e-4 (sums of six
    log-probs near -1e0..-1e1 in another order)."""
    cfg = cap_config()
    cap, jcap, params = shared_captioner(cfg, seed=seed)
    params["logit_w"] = params["logit_w"] * 4.0
    with torch.no_grad():
        cap.logit.weight.mul_(4.0)
    fc, att, _, _ = caption_inputs(seed=seed)
    jseq, jscore = jcap.apply({"params": params}, fc, att, 3,
                              method=JCaptioner.sample_beam)
    seq, score = cap.sample_beam(*_t(fc, att), beam_size=3)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=0,
                               atol=1e-4)
    gseq, glp = cap.sample_greedy(*_t(fc, att))
    # the beam's best is at least as likely as the greedy path (UNK aside)
    assert bool((score >= glp.sum(1) - 1e-4).all())


def test_beam_extends_finished_beams_with_pad():
    """A captioner whose logit bias makes EOS certain ends every beam at
    step 0 and pads the rest; UNK is never chosen even when it is the
    most likely word."""
    cfg = cap_config()
    cap, _, _ = shared_captioner(cfg)
    fc, att, _, _ = caption_inputs()
    with torch.no_grad():
        cap.logit.bias.zero_()
        cap.logit.bias[0] = 50.0
        seq, score = cap.sample_beam(*_t(fc, att), beam_size=4)
        assert not seq.any() and bool((score > -1e-3).all())
        cap.logit.bias[0] = 0.0
        cap.logit.bias[16] = 50.0                  # UNK
        seq, _ = cap.sample_beam(*_t(fc, att), beam_size=4)
    assert not bool((seq == 16).any())


def test_dropout_and_scheduled_sampling():
    """In train mode the captioner draws from the caller's generator:
    the same seed gives the same log-probs, another seed others; dropout
    keeps 1 - p of an embed and scales it by 1 / (1 - p); scheduled
    sampling at p = 1 leaves step 0 as teacher forcing and changes the
    later steps, at p = 0 it is teacher forcing; eval mode draws nothing;
    train mode with dropout and no generator raises."""
    cfg = cap_config(cap_drop_prob_lm=0.5)
    cap, _, _ = shared_captioner(cfg)
    fc, att, seq, mask = _t(*caption_inputs())
    cap.train()
    a = cap.teacher_forced_logprobs(fc, att, seq,
                                    torch.Generator().manual_seed(0))
    b = cap.teacher_forced_logprobs(fc, att, seq,
                                    torch.Generator().manual_seed(0))
    c = cap.teacher_forced_logprobs(fc, att, seq,
                                    torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(5)
    emb, _, _ = cap._prep_feats(fc, att, g)
    ref, _, _ = cap._prep_feats(fc, att)
    kept = emb != 0
    assert abs(float(kept[ref > 0].float().mean()) - 0.5) < 0.05
    torch.testing.assert_close(emb[kept], 2.0 * ref[kept])
    with pytest.raises(ValueError, match="Generator"):
        cap.teacher_forced_logprobs(fc, att, seq)

    cfg = cap_config()                              # no dropout
    cap, _, _ = shared_captioner(cfg)
    cap.train()
    tf = cap.teacher_forced_logprobs(fc, att, seq)
    ss0 = cap.teacher_forced_logprobs(fc, att, seq,
                                      torch.Generator().manual_seed(0), 0.0)
    ss1 = cap.teacher_forced_logprobs(fc, att, seq,
                                      torch.Generator().manual_seed(0), 1.0)
    again = cap.teacher_forced_logprobs(fc, att, seq,
                                        torch.Generator().manual_seed(0), 1.0)
    assert torch.equal(tf, ss0) and torch.equal(ss1, again)
    torch.testing.assert_close(ss1[:, 0], tf[:, 0])
    assert not torch.allclose(ss1[:, 1:], tf[:, 1:])
    cap.eval()
    torch.testing.assert_close(
        cap.teacher_forced_logprobs(fc, att, seq, None, 1.0), tf)
    with pytest.raises(ValueError, match="Generator"):
        cap.train().teacher_forced_logprobs(fc, att, seq, None, 0.5)


def test_gumbel_sample_follows_the_distribution():
    """The scheduled-sampling draw is a categorical sample of the row's
    log-probs: frequencies within 0.01 of the probabilities."""
    from lang2seg_tpu_torch.models.captioner import _gumbel_argmax
    probs = torch.tensor([0.5, 0.3, 0.15, 0.05])
    logp = torch.log(probs).expand(40000, 4)
    draws = _gumbel_argmax(logp, torch.Generator().manual_seed(0))
    freq = torch.bincount(draws, minlength=4).float() / 40000
    assert float((freq - probs).abs().max()) < 0.01


@pytest.mark.parametrize("h,w", [(40, 64), (8, 12), (14, 14)])
def test_adaptive_pool_matches_jax(rng, h, w):
    """torch adaptive_avg_pool2d semantics against the JAX slices of
    floor / ceil bins, overlapping where the map is smaller than 14:
    within 1e-6 (f32 means in another order)."""
    x = rng.randn(2, h, w, 6).astype(np.float32)
    want = np.asarray(j_adaptive_pool(jnp.asarray(x), 14))
    got = _adaptive_pool(torch.from_numpy(x), 14).numpy()
    assert got.shape == want.shape == (2, 14, 14, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_setup_captioner_by_name():
    m = to_port_cfg(cap_config()).model
    for name in ("att2in2", "att2in"):
        m.caption_model = name
        assert setup_captioner(m).vocab_size == 16
    # the other decoders of the zoo (tests/test_torch_caption_zoo.py)
    for name in ("show_tell", "fc", "topdown", "show_attend_tell", "adaatt"):
        m.caption_model = name
        assert not isinstance(setup_captioner(m), Att2In2Captioner)
    m.caption_model = "nope"
    with pytest.raises(ValueError):
        setup_captioner(m)


def test_caption_targets_match_jax_loader(rng):
    labels = rng.randint(1, 50, (6, 10)).astype(np.int32)
    for i, n in enumerate((0, 1, 4, 9, 10, 3)):
        labels[i, n:] = 0
    want = GtBatchLoader._caption_targets(None, labels)
    got = caption_targets(labels)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_scheduled_sampling_prob_matches_jax():
    for args in [(0,), (3, 2), (2, 2), (7, 2, 2, 0.1, 0.25),
                 (40, 0, 5, 0.05, 0.25), (12, 5, 3, 0.05, 0.1)]:
        assert scheduled_sampling_prob(*args) == \
            jscheduled_sampling_prob(*args)


def test_adam_steps_match_optax():
    """Three captioner steps on Adam(lr 5e-4) against the JAX package's
    step on optax.adam, same weights and batches: every parameter within
    2e-6 abs after the steps (each step moves an entry by up to 5e-4).
    alpha_net's bias has a gradient of rounding noise only (see
    test_nll_gradients_match_jax), which Adam normalises to an arbitrary
    step: it is held to 3 steps of lr."""
    cfg = cap_config()
    pcfg = to_port_cfg(cfg)
    state = init_captioner_state(pcfg, device="cpu", seed=3)
    _, jcap, params = shared_captioner(cfg, seed=3)
    step_fn, tx = make_captioner_train_step(jcap)
    jstate = JCaptionerTrainState(step=jnp.zeros((), jnp.int32),
                                  params=params, opt_state=tx.init(params),
                                  rng=jax.random.PRNGKey(0))
    for s in range(3):
        batch = caption_inputs(seed=10 + s)
        loss = captioner_train_step(state, *_t(*batch))
        jstate, jloss = step_fn(jstate, *(jnp.asarray(a) for a in batch))
        assert abs(float(loss) - float(jloss)) <= 1e-5
    assert state.step == 3
    got = convert_captioner({k: v.numpy() for k, v in
                             captioner_state_dict(state.captioner).items()})
    for path, w in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        key = jax.tree_util.keystr(path)
        g = dict(jax.tree_util.tree_flatten_with_path(got)[0])[path]
        tol = 3 * 5e-4 if key == "['alpha_b']" else 2e-6
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=tol, err_msg=key)


def test_pretraining_loop_checkpoint_and_restore(tmp_path):
    """run_captioner_training: the scheduled-sampling schedule by epoch,
    finite losses, a best-validation checkpoint under caption_model.*
    keys; restore_captioner grafts it into a cycle network's state_dict
    (only caption_model.* entries change, each keeping its dtype) and
    refuses a checkpoint of other keys or shapes."""
    cfg = to_port_cfg(cap_config(cap_ss_start=1, cap_ss_increase_every=1,
                                 cap_drop_prob_lm=0.5))
    batches = [tuple(_t(*caption_inputs(seed=s))) for s in range(4)]
    out = run_captioner_training(
        cfg, iter(batches * 2), max_iters=6, iters_per_epoch=2,
        val_iter=iter(batches * 3), val_every=2, ckpt_dir=str(tmp_path),
        device="cpu")
    hist = out["history"]
    assert [h["ss_prob"] for h in hist] == [0.0, 0.0, 0.0, 0.0, 0.05, 0.05]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert np.isfinite(out["best_val"]) and out["state"].step == 6
    ckpt = tmp_path / "model-best.pth"
    saved = torch.load(ckpt, weights_only=True)
    assert set(saved) == set(init_captioner_params(cfg, 0))

    from lang2seg_tpu_torch.weights import init_params
    net_cfg = to_port_cfg(cap_config())
    sd = init_params(net_cfg, 0)
    new = restore_captioner(sd, str(ckpt))
    assert list(new) == list(sd)
    for k in sd:
        if k.startswith("caption_model."):
            assert torch.equal(new[k], saved[k]) and new[k].dtype == sd[k].dtype
        else:
            assert new[k] is sd[k]
    assert any(not torch.equal(new[k], sd[k]) for k in saved)
    bad = dict(saved)
    bad.pop("caption_model.logit.bias")
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="keys differ"):
        restore_captioner(sd, str(tmp_path / "bad.pth"))
    bad = dict(saved, **{"caption_model.logit.bias": torch.zeros(3)})
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="shape"):
        restore_captioner(sd, str(tmp_path / "bad.pth"))
    no_cap = {k: v for k, v in sd.items()
              if not k.startswith("caption_model.")}
    with pytest.raises(ValueError, match="caption_model"):
        restore_captioner(no_cap, str(ckpt))


def test_init_captioner_params_distributions():
    """The flax init of the JAX captioner: embed normal(0.01), matrices
    lecun-normal (variance 1 / fan_in), biases zero; same seed, same
    weights."""
    cfg = to_port_cfg(cap_config(cap_rnn_size=256,
                                 cap_input_encoding_size=256))
    sd = init_captioner_params(cfg, 0)
    assert all(torch.equal(v, init_captioner_params(cfg, 0)[k])
               for k, v in sd.items())
    assert abs(float(sd["caption_model.embed.0.weight"].std()) - 0.01) < 1e-3
    for key, fan_in in (("caption_model.core.i2h.weight", 256),
                        ("caption_model.core.h2h.weight", 256),
                        ("caption_model.logit.weight", 256)):
        std = float(sd[key].std())
        assert abs(std - fan_in ** -0.5) < 0.05 * fan_in ** -0.5, key
    biases = [k for k in sd if k.endswith(".bias")]
    assert len(biases) == 9
    assert all(float(sd[k].abs().max()) == 0.0 for k in biases)
