"""Weights for the port: random full-width initialization and the bridge
from the JAX package's params tree.

Both produce a state_dict under the reference network's keys, which is
what `models.network.Lang2Seg` holds:

* `init_params(cfg, seed)` draws every tensor from a `torch.Generator`
  with the distributions of the JAX package's `engine/train_state.py::
  init_params` (the flax defaults): lecun-normal (truncated) convs and
  Dense layers, normal(0.01) RPN/cls/mask heads, normal(0.001) box
  deltas, normal(1/sqrt(D)) embeddings, uniform [0, 1/sqrt(H)) LSTM
  weights, zero biases and identity frozen BatchNorm.
* `from_jax_params(params, cfg)` converts a JAX params tree (nested
  dicts of numpy arrays) into that state_dict: the inverse of the JAX
  package's `engine/convert.py::convert_torch_state_dict` (conv
  HWIO -> OIHW, Dense (I, O) -> (O, I), the RPN class-major channel
  order, the fused `dynamic_fc` split into `dynamic_fc_0..6`, the
  flipped ConvTranspose kernel, the LSTM's transposed gate matrices).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from .config import Config
from .models.resnet import STAGE_BLOCKS

# flax's lecun_normal draws a standard normal truncated to [-2, 2] and
# divides the scale by that distribution's std, so the result has
# variance 1 / fan_in (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _trunc_normal(shape, std: float, g: torch.Generator) -> torch.Tensor:
    """N(0, std^2) truncated to +-2 std, by inverse-CDF sampling."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.empty(shape).uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0,
                                    generator=g)
    return torch.erfinv(u) * (math.sqrt(2.0) * std)


def _lecun_normal(shape, g):
    fan_in = int(np.prod(shape[1:]))        # (O, I, kh, kw) or (O, I)
    return _trunc_normal(shape, math.sqrt(1.0 / fan_in) / _TRUNC_STD, g)


def _normal(std):
    return lambda shape, g: torch.empty(shape).normal_(0.0, std, generator=g)


def _initializer(key: str, cfg: Config):
    """The flax default that `engine/train_state.py::init_params` gives
    the JAX counterpart of the state_dict entry `key`."""
    leaf = key.rsplit(".", 1)[-1]
    if ".bn" in key or ".downsample.1." in key:        # frozen BN: identity
        if leaf in ("weight", "running_var"):
            return lambda shape, g: torch.ones(shape)
        return lambda shape, g: torch.zeros(shape)
    if key.startswith("resnet."):
        return _lecun_normal
    if leaf.startswith("bias"):
        return lambda shape, g: torch.zeros(shape)
    if key == "rnn_encoder.embedding.weight":
        return _normal(1.0 / math.sqrt(cfg.model.word_embedding_size))
    if key.startswith("rnn_encoder.rnn."):
        bound = 1.0 / math.sqrt(cfg.model.rnn_hidden_size)
        return lambda shape, g: torch.empty(shape).uniform_(
            0.0, bound, generator=g)
    if key.startswith(("rpn_", "cls_score_net", "mask_")):
        return _normal(0.01)
    if key.startswith("bbox_pred_net"):
        return _normal(0.001)
    return _lecun_normal                     # mlp, dynamic_fc*, response_fc


def init_params(cfg: Config, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Full state_dict for `Lang2Seg(cfg)`, on the CPU, drawn from
    torch.Generator(seed) in the module's key order."""
    g = torch.Generator().manual_seed(seed)
    return OrderedDict((k, _initializer(k, cfg)(shape, g).float())
                       for k, shape in state_dict_shapes(cfg).items())


# ---------------------------------------------------------------------------
# JAX params tree -> reference-keyed state_dict
# ---------------------------------------------------------------------------


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _conv(k):                     # (kh, kw, I, O) -> (O, I, kh, kw)
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _lin(k):                      # (I, O) -> (O, I)
    return _t(np.asarray(k).T)


def _bn(out, prefix, p):
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(p["mean"])
    out[f"{prefix}.running_var"] = _t(p["var"])


def _resnet(out, p, depth):
    out["resnet.conv1.weight"] = _conv(p["conv1"]["kernel"])
    _bn(out, "resnet.bn1", p["bn1"])
    for li, n in enumerate(STAGE_BLOCKS[depth], start=1):
        for bi in range(n):
            blk = p[f"layer{li}"][f"block{bi}"]
            tb = f"resnet.layer{li}.{bi}"
            for ci in (1, 2, 3):
                out[f"{tb}.conv{ci}.weight"] = _conv(blk[f"conv{ci}"]["kernel"])
                _bn(out, f"{tb}.bn{ci}", blk[f"bn{ci}"])
            if "downsample_conv" in blk:
                out[f"{tb}.downsample.0.weight"] = _conv(
                    blk["downsample_conv"]["kernel"])
                _bn(out, f"{tb}.downsample.1", blk["downsample_bn"])


def _encoder(out, p):
    out["rnn_encoder.embedding.weight"] = _t(p["embedding"]["embedding"])
    out["rnn_encoder.mlp.0.weight"] = _lin(p["mlp"]["kernel"])
    out["rnn_encoder.mlp.0.bias"] = _t(p["mlp"]["bias"])
    for jax_name, sfx in (("lstm_fwd", "_l0"), ("lstm_bwd", "_l0_reverse")):
        if jax_name not in p:
            continue
        lp = p[jax_name]
        out[f"rnn_encoder.rnn.weight_ih{sfx}"] = _lin(lp["w_ih"])
        out[f"rnn_encoder.rnn.weight_hh{sfx}"] = _lin(lp["w_hh"])
        out[f"rnn_encoder.rnn.bias_ih{sfx}"] = _t(lp["bias_ih"])
        out[f"rnn_encoder.rnn.bias_hh{sfx}"] = _t(lp["bias_hh"])


def _filters(out, p, num_filters, c4_dim):
    kern = np.asarray(p["dynamic_fc"]["kernel"])      # (D, C * K)
    bias = np.asarray(p["dynamic_fc"]["bias"])
    if num_filters == 1:
        out["dynamic_fc.weight"] = _lin(kern)
        out["dynamic_fc.bias"] = _t(bias)
        return
    for k in range(num_filters):
        sl = slice(k * c4_dim, (k + 1) * c4_dim)
        out[f"dynamic_fc_{k}.weight"] = _lin(kern[:, sl])
        out[f"dynamic_fc_{k}.bias"] = _t(bias[sl])
    out["response_fc.weight"] = _lin(p["response_fc"]["kernel"])
    out["response_fc.bias"] = _t(p["response_fc"]["bias"])


def _rpn(out, p, num_anchors):
    out["rpn_net.weight"] = _conv(p["rpn_conv"]["kernel"])
    out["rpn_net.bias"] = _t(p["rpn_conv"]["bias"])
    # JAX channel a * 2 + c -> reference channel c * A + a
    inv = np.asarray([ai * 2 + c for c in range(2)
                      for ai in range(num_anchors)])
    out["rpn_cls_score_net.weight"] = _conv(
        np.asarray(p["rpn_cls"]["kernel"])[..., inv])
    out["rpn_cls_score_net.bias"] = _t(np.asarray(p["rpn_cls"]["bias"])[inv])
    out["rpn_bbox_pred_net.weight"] = _conv(p["rpn_bbox"]["kernel"])
    out["rpn_bbox_pred_net.bias"] = _t(p["rpn_bbox"]["bias"])


def _heads(out, params):
    bh = params["box_head"]
    out["cls_score_net.weight"] = _lin(bh["cls_score"]["kernel"])
    out["cls_score_net.bias"] = _t(bh["cls_score"]["bias"])
    out["bbox_pred_net.weight"] = _lin(bh["bbox_pred"]["kernel"])
    out["bbox_pred_net.bias"] = _t(bh["bbox_pred"]["bias"])
    if "mask_head" in params:
        mh = params["mask_head"]
        # flax kernel (kh, kw, I, O) holds the ConvTranspose taps flipped
        up = np.asarray(mh["mask_up"]["kernel"])[::-1, ::-1]
        out["mask_up_sampling.weight"] = _t(up.transpose(2, 3, 0, 1))
        out["mask_up_sampling.bias"] = _t(mh["mask_up"]["bias"])
        out["mask_pred_net.weight"] = _conv(mh["mask_pred"]["kernel"])
        out["mask_pred_net.bias"] = _t(mh["mask_pred"]["bias"])


def from_jax_params(params, cfg: Config) -> Dict[str, torch.Tensor]:
    """JAX params tree (nested dicts of arrays, as `init_params` of the
    JAX package returns after `jax.device_get`) -> the port's state_dict."""
    m = cfg.model
    out: Dict[str, torch.Tensor] = OrderedDict()
    _resnet(out, params["backbone"], m.backbone)
    _encoder(out, params["encoder"])
    _filters(out, params["filter_gen"], m.num_filters, m.c4_feat_dim)
    _rpn(out, params["rpn_head"],
         len(m.anchor_scales) * len(m.anchor_ratios))
    _heads(out, params)
    return out


def state_dict_shapes(cfg: Config) -> Dict[str, Tuple[int, ...]]:
    """Key -> shape of the port's state_dict, without allocating it."""
    from .models.network import Lang2Seg
    with torch.device("meta"):
        return {k: tuple(v.shape)
                for k, v in Lang2Seg(cfg).state_dict().items()}
