"""The port's MAttNet matching modules (`models/matching.py`) against the
JAX package's, on seeded inputs with the port's weights carried to flax:
PhraseAttention (pads masked out, a row of pads only), the max-margin
loss, VisualEncoder and JointMatching (a zero vector's norm floor), all
within 1e-6, and their gradients within 1e-5 of each tensor's max."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lang2seg_tpu.models import matching as jmatch
from lang2seg_tpu_torch.models import matching as pmatch


def _dense(layer):
    return {"kernel": jnp.asarray(layer.weight.detach().numpy().T.copy()),
            "bias": jnp.asarray(layer.bias.detach().numpy().copy())}


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def test_phrase_attention_matches_jax(rng):
    torch.manual_seed(0)
    mod = pmatch.PhraseAttention(24)
    context = rng.randn(4, 7, 24).astype(np.float32)
    embedded = rng.randn(4, 7, 16).astype(np.float32)
    labels = rng.randint(1, 30, (4, 7)).astype(np.int32)
    labels[1, 4:] = 0
    labels[2, :] = 0                        # all pads: the 1e-8 floor
    labels[3, ::2] = 0
    params = {"fc": _dense(mod.fc)}
    want_a, want_w = jmatch.PhraseAttention().apply(
        {"params": params}, context, embedded, labels)
    got_a, got_w = mod(*(torch.from_numpy(x) for x in
                         (context, embedded, labels)))
    _close(got_a.detach(), want_a)
    _close(got_w.detach(), want_w)
    assert float(got_a[2].detach().abs().max()) == 0.0
    np.testing.assert_allclose(got_a.detach().sum(1).numpy()[[0, 1, 3]], 1.0,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("margin,vw,lw", [(0.1, 1.0, 1.0), (0.5, 0.3, 2.0)])
def test_max_margin_loss_matches_jax(rng, margin, vw, lw):
    paired, uv, ul = (rng.randn(32).astype(np.float32) * 0.3
                      for _ in range(3))
    want = jmatch.max_margin_loss(paired, uv, ul, margin, vw, lw)
    got = pmatch.max_margin_loss(*(torch.from_numpy(x) for x in
                                   (paired, uv, ul)), margin, vw, lw)
    _close(got, want)
    assert float(got) > 0.0


def test_visual_encoder_and_joint_matching_match_jax(rng):
    torch.manual_seed(1)
    enc = pmatch.VisualEncoder(40, 5, dim=32)
    joint = pmatch.JointMatching(32, 24, dim=32)
    region = rng.randn(6, 40).astype(np.float32)
    loc = rng.randn(6, 5).astype(np.float32)
    lang = rng.randn(6, 24).astype(np.float32)
    lang[2] = 0.0
    with torch.no_grad():
        joint.lang_emb.bias.zero_()         # row 2 embeds to zero
    enc_p = {"proj1": _dense(enc.proj1), "proj2": _dense(enc.proj2)}
    joint_p = {"vis_emb": _dense(joint.vis_emb),
               "lang_emb": _dense(joint.lang_emb)}

    def jax_fn(enc_p, joint_p, lang):
        v = jmatch.VisualEncoder(dim=32).apply({"params": enc_p}, region, loc)
        return jmatch.JointMatching(dim=32).apply({"params": joint_p}, v,
                                                  lang)
    want = jax_fn(enc_p, joint_p, lang)
    tr = [torch.from_numpy(x) for x in (region, loc, lang)]
    with torch.no_grad():
        v = enc(tr[0], tr[1])
        got = joint(v, tr[2])
    _close(v, jmatch.VisualEncoder(dim=32).apply(
        {"params": enc_p}, region, loc))
    _close(got, want)
    assert float(got[2]) == 0.0
    assert float(got.abs().max()) <= 1.0 + 1e-6
    # gradients of the summed scores, away from the zero row (whose norm
    # has no gradient: NaN in JAX, 0 in torch)
    lang[2] = rng.randn(24)
    jg = jax.grad(lambda a, b: jnp.sum(jax_fn(a, b, lang)),
                  argnums=(0, 1))(enc_p, joint_p)
    joint(enc(tr[0], tr[1]), torch.from_numpy(lang)).sum().backward()
    for mod, tree in ((enc, jg[0]), (joint, jg[1])):
        for name, sub in tree.items():
            layer = getattr(mod, name)
            for g, w in ((layer.weight.grad.numpy().T, sub["kernel"]),
                         (layer.bias.grad.numpy(), sub["bias"])):
                w = np.asarray(w)
                assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), name
