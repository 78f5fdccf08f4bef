"""Modules of the PyTorch port (lang2seg_tpu_torch.models) against the JAX
package's on the same weights (carried across by the reference-keyed
state_dict, tests/test_torch_weights.py::shared_weights) and the same
seeded numpy inputs, at the tiny test config (resnet26, 128x192, f32).

Tolerances: 1e-4 for single layers and the language encoder; 1e-3 for
the backbone stack (many convolutions summed in another order), as the
torch parity harness tests/test_torch_parity.py uses."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_weights import response_config, shared_weights


@pytest.fixture(scope="module")
def nets():
    cfg = response_config()
    model, jmodel, params = shared_weights(cfg, seed=1)
    return cfg, model, jmodel, params


def _apply(jmodel, params, fn, *args):
    with jax.default_matmul_precision("float32"):
        return jmodel.apply({"params": params}, *args, method=fn)


def test_backbone_head_and_tail(nets, rng):
    cfg, model, jmodel, params = nets
    images = rng.randn(1, cfg.data.canvas_h, cfg.data.canvas_w,
                       3).astype(np.float32) * 30.0
    want = np.asarray(_apply(jmodel, params,
                             lambda m, x: m.backbone.head(x), images))
    got = model.resnet.head(torch.from_numpy(images))
    assert got.shape == (1, 8, 12, 1024)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-3,
                               atol=1e-3)

    crops = (rng.randn(5, 7, 7, 1024) * 0.5).astype(np.float32)
    want = np.asarray(_apply(jmodel, params,
                             lambda m, x: m.backbone.tail(x), crops))
    got = model.resnet.tail(torch.from_numpy(crops)).detach().numpy()
    assert got.shape == (5, 7, 7, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_language_encoder(nets, rng):
    cfg, model, jmodel, params = nets
    labels = rng.randint(1, cfg.model.vocab_size,
                         (4, cfg.data.max_len)).astype(np.int32)
    for i, ln in enumerate([10, 3, 1, 0]):
        labels[i, ln:] = 0
    jout = _apply(jmodel, params,
                  lambda m, lb: m.encoder(lb, train=False), labels)
    with torch.no_grad():
        pout = model.rnn_encoder(torch.from_numpy(labels))
    for got, want in zip(pout, jout):          # output, hidden, embedded
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_conditioning(nets, rng):
    """Encoder + 7 filters + sigmoid gate on a broadcast map."""
    cfg, model, jmodel, params = nets
    conv = (rng.randn(1, 8, 12, 1024) * 0.5).astype(np.float32)
    labels = rng.randint(1, cfg.model.vocab_size, (3, 10)).astype(np.int32)
    labels[1, 4:] = 0
    jconv = jnp.broadcast_to(jnp.asarray(conv), (3, 8, 12, 1024))
    wg, wr = _apply(jmodel, params,
                    lambda m, c, lb: m._condition(c, lb, train=False),
                    jconv, labels)
    with torch.no_grad():
        gg, gr = model._condition(torch.from_numpy(conv).expand(3, -1, -1, -1),
                                  torch.from_numpy(labels))
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=1e-4,
                               atol=1e-4)


def test_rpn_head(nets, rng):
    """Includes the reference's class-major cls channel order."""
    cfg, model, jmodel, params = nets
    gated = (rng.randn(2, 8, 12, 1024) * 0.5).astype(np.float32)
    wc, wb = _apply(jmodel, params, lambda m, g: m.rpn_head(g), gated)
    with torch.no_grad():
        gc, gb = model.rpn_head(torch.from_numpy(gated))
    assert gc.shape == (2, 8, 12, 12, 2) and gb.shape == (2, 8, 12, 12, 4)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-4,
                               atol=1e-4)


def test_box_and_mask_heads(nets, rng):
    cfg, model, jmodel, params = nets
    fc7 = np.abs(rng.randn(6, 7, 7, 2048)).astype(np.float32)
    ws, wb = _apply(jmodel, params, lambda m, x: m.box_head(x), fc7)
    with torch.no_grad():
        gs, gb = model.box_head(torch.from_numpy(fc7))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-4,
                               atol=1e-4)

    labels = np.asarray([1, 80, 3, 3, 40, 7], np.int32)
    want = _apply(jmodel, params, lambda m, x, lb: m.mask_head(x, labels=lb),
                  fc7, labels)
    with torch.no_grad():
        got = model.mask_head(torch.from_numpy(fc7),
                              labels=torch.from_numpy(labels))
    assert got.shape == (6, 14, 14)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_roi_features_and_predict_masks(nets, rng):
    """Crop -> layer4 tail, and the mask branch on given boxes."""
    cfg, model, jmodel, params = nets
    gated = (rng.randn(2, 8, 12, 1024) * 0.5).astype(np.float32)
    boxes = np.asarray([[[16.0, 8.0, 100.0, 90.0], [0.0, 0.0, 191.0, 127.0]],
                        [[40.0, 30.0, 180.0, 120.0], [5.0, 60.0, 50.0, 120.0]]],
                       np.float32)
    labels = np.asarray([[3, 7], [1, 80]], np.int32)
    want = _apply(jmodel, params, lambda m, g, b: m._roi_features(g, b),
                  gated, boxes)
    wm = _apply(jmodel, params,
                lambda m, g, b, lb: m.predict_masks(g, b, lb),
                gated, boxes, labels)
    with torch.no_grad():
        got = model._roi_features(torch.from_numpy(gated),
                                  torch.from_numpy(boxes))
    gm = model.predict_masks(torch.from_numpy(gated), torch.from_numpy(boxes),
                             torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    assert gm.shape == (2, 2, 14, 14)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-4,
                               atol=1e-4)
