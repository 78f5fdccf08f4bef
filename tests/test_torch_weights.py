"""Weights of the PyTorch port (lang2seg_tpu_torch.weights) against the JAX
package: the port's state_dict carries the reference keys, so the JAX
package's `engine/convert.py::convert_torch_state_dict` maps it onto the
JAX params tree with zero unmatched leaves, and `from_jax_params` is its
exact inverse. Also home of the helpers the other tests/test_torch_*.py
files share: the same seeded weights in both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from lang2seg_tpu.engine.convert import convert_torch_state_dict
from lang2seg_tpu.engine.train_state import create_model
from lang2seg_tpu.models.network import Lang2Seg as JaxLang2Seg
from lang2seg_tpu_torch import config as port_config
from lang2seg_tpu_torch.models.network import build_model
from lang2seg_tpu_torch.weights import (from_jax_params, init_params,
                                        state_dict_shapes)
from tests.test_network import tiny_config


def response_config(**model_kw):
    """tests/test_network.py::tiny_config (resnet26, 128x192, f32 compute)
    with the `response` variant's conditioning: 7 filters, sigmoid gate,
    normalized response."""
    kw = dict(num_filters=7, response_gate="sigmoid", use_response_loss=True)
    kw.update(model_kw)
    return tiny_config(**kw)


def to_port_cfg(cfg):
    """The port's Config with the same field values as a JAX Config."""
    out = port_config.Config()
    for section in ("train", "test", "model", "data", "parallel"):
        for k, v in dataclasses.asdict(getattr(cfg, section)).items():
            setattr(getattr(out, section), k, v)
    out.seed = cfg.seed
    return out


def shared_weights(cfg, seed=0, scale_rpn_cls=1.0):
    """(port model on the CPU, JAX model, JAX params) holding the same
    weights: the port's init_params(seed), carried to JAX through
    convert_torch_state_dict. `scale_rpn_cls` multiplies the RPN class
    logits' weights in both (see tests/test_torch_slice.py)."""
    pcfg = to_port_cfg(cfg)
    sd = init_params(pcfg, seed)
    if scale_rpn_cls != 1.0:
        sd["rpn_cls_score_net.weight"] = sd["rpn_cls_score_net.weight"] \
            * scale_rpn_cls
        sd["rpn_cls_score_net.bias"] = sd["rpn_cls_score_net.bias"] \
            * scale_rpn_cls
    model = build_model(pcfg, device="cpu", state_dict=sd)
    params = convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, cfg)
    return model, create_model(cfg), params


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): leaf for p, leaf in leaves}


def _jax_param_shapes(cfg):
    """Path -> shape of the JAX model's params, by abstract evaluation of
    its init (no arrays are computed)."""
    from lang2seg_tpu.engine.train_state import init_params as jax_init
    model = create_model(cfg)
    tree = jax.eval_shape(lambda k: jax_init(model, cfg, k),
                          jax.random.PRNGKey(0))
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("num_filters,gate", [(7, "sigmoid"),
                                              (1, "multiply")])
def test_port_state_dict_maps_onto_jax_tree(num_filters, gate):
    """convert_torch_state_dict(port state_dict) covers every JAX param
    with the right shape, and nothing else."""
    cfg = response_config(num_filters=num_filters, response_gate=gate)
    sd = init_params(to_port_cfg(cfg), 0)
    assert list(sd) == list(state_dict_shapes(to_port_cfg(cfg)))
    tree = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                    cfg)
    got = {k: tuple(np.shape(v)) for k, v in _flat(tree).items()}
    want = _jax_param_shapes(cfg)
    assert sorted(set(want) - set(got)) == []
    assert sorted(set(got) - set(want)) == []
    assert {k: got[k] for k in want if got[k] != want[k]} == {}


@pytest.mark.parametrize("num_filters", [7, 1])
def test_from_jax_params_inverts_convert(num_filters):
    """from_jax_params(tree) -> convert_torch_state_dict gives the tree
    back bit for bit, and yields exactly the port's keys and shapes."""
    cfg = response_config(num_filters=num_filters)
    rng = np.random.RandomState(num_filters)
    tree = {}
    for path, shape in _jax_param_shapes(cfg).items():
        keys = [p.strip("[]'") for p in path.split("][")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = rng.standard_normal(shape).astype(np.float32)
    sd = from_jax_params(tree, cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        state_dict_shapes(to_port_cfg(cfg))
    back = _flat(convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, cfg))
    orig = _flat(tree)
    assert set(back) == set(orig)
    for k in orig:
        np.testing.assert_array_equal(np.asarray(back[k]), orig[k], err_msg=k)


def test_init_params_distributions():
    """init_params draws the flax defaults of the JAX package's init:
    lecun-normal (truncated) convs and Dense, normal heads, uniform
    [0, 1/sqrt(H)) LSTM, zero biases, identity frozen BatchNorm; the
    same seed gives the same weights."""
    cfg = to_port_cfg(response_config())
    sd = init_params(cfg, 0)
    again = init_params(cfg, 0)
    assert all(torch.equal(sd[k], again[k]) for k in sd)

    def check_std(key, want, tol=0.05):
        got = float(sd[key].std())
        assert abs(got - want) <= tol * want, (key, got, want)

    conv = sd["resnet.layer3.0.conv2.weight"]               # (256,256,3,3)
    check_std("resnet.layer3.0.conv2.weight", (1.0 / (256 * 9)) ** 0.5)
    # truncation at 2 std of the pre-correction normal
    assert float(conv.abs().max()) <= 2.0 * (1.0 / (256 * 9)) ** 0.5 \
        / 0.87962566103423978 + 1e-6
    check_std("dynamic_fc_3.weight", (1.0 / 1024) ** 0.5)
    check_std("rpn_net.weight", 0.01)
    check_std("cls_score_net.weight", 0.01)
    check_std("bbox_pred_net.weight", 0.001)
    check_std("mask_up_sampling.weight", 0.01)
    check_std("rnn_encoder.embedding.weight", (1.0 / 512) ** 0.5)
    w = sd["rnn_encoder.rnn.weight_hh_l0_reverse"]
    assert float(w.min()) >= 0.0 and float(w.max()) < 512 ** -0.5
    assert abs(float(w.mean()) - 0.5 * 512 ** -0.5) < 0.01 * 512 ** -0.5
    for k in ("rpn_net.bias", "dynamic_fc_0.bias", "mask_pred_net.bias",
              "resnet.layer2.0.bn3.bias", "resnet.bn1.running_mean"):
        assert float(sd[k].abs().max()) == 0.0, k
    for k in ("resnet.layer1.0.downsample.1.weight",
              "resnet.layer4.0.bn2.running_var"):
        assert float((sd[k] - 1.0).abs().max()) == 0.0, k


def test_jax_model_takes_converted_port_weights(rng):
    """The shared-weights helper feeds one state_dict to both packages:
    the JAX backbone head on the converted tree equals the port's."""
    cfg = response_config()
    model, jmodel, params = shared_weights(cfg)
    images = rng.randn(1, 64, 96, 3).astype(np.float32) * 30.0
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jmodel.apply(
            {"params": params}, images,
            method=lambda m, x: m.backbone.head(x)))
    got = model.resnet.head(torch.from_numpy(images)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert isinstance(jmodel, JaxLang2Seg)
