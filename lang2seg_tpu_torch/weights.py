"""Weights for the port: random full-width initialization and the bridge
from the JAX package's params tree.

Both produce a state_dict under the reference network's keys, which is
what `models.network.Lang2Seg` holds:

* `init_params(cfg, seed)` draws every tensor from a `torch.Generator`
  with the distributions of the JAX package's `engine/train_state.py::
  init_params` (the flax defaults): lecun-normal (truncated) convs and
  Dense layers, normal(0.01) RPN/cls/mask heads, normal(0.001) box
  deltas, normal(1/sqrt(D)) embeddings, uniform [0, 1/sqrt(H)) LSTM
  weights, zero biases and identity frozen BatchNorm; the captioner's
  word embedding normal(0.01), its other matrices lecun-normal (a zoo
  decoder's raw (in, out) matrices by their first axis), the attribute
  head lecun-normal.
* `from_jax_params(params, cfg)` converts a JAX params tree (nested
  dicts of numpy arrays) into that state_dict: the inverse of the JAX
  package's `engine/convert.py::convert_torch_state_dict` (conv
  HWIO -> OIHW, Dense (I, O) -> (O, I), the RPN class-major channel
  order, VGG16's fc6 input rows from (7, 7, C) back to the reference's
  channel-major (C, 7, 7), MobileNetV1 under its JAX module names (its
  depthwise kernels (3, 3, 1, C) -> (C, 1, 3, 3)), the fused `dynamic_fc` split into
  `dynamic_fc_0..6`, the flipped ConvTranspose kernel, the LSTM's
  transposed gate matrices, the att2in2 captioner's raw `*_w` / `*_b`
  params back to its reference layers; a zoo decoder's raw params as
  they are, its Dense layers as Linear ones; the attribute head's
  Dense as `att_head`).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from .config import Config
from .models.mobilenet import BLOCKS_HEAD, BLOCKS_TAIL
from .models.resnet import STAGE_BLOCKS

# vgg16 `features` index -> the JAX package's conv name
VGG_FEATURES = {0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2",
                10: "conv3_1", 12: "conv3_2", 14: "conv3_3", 17: "conv4_1",
                19: "conv4_2", 21: "conv4_3", 24: "conv5_1", 26: "conv5_2",
                28: "conv5_3"}

CAPTION_PREFIX = "caption_model."

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


def _lecun_normal_in_out(shape, g):
    """lecun-normal of a raw (in, out) matrix, as the JAX tree holds it."""
    return _trunc_normal(shape, math.sqrt(1.0 / shape[0]) / _TRUNC_STD, g)


def _normal(std):
    return lambda shape, g: torch.empty(shape).normal_(0.0, std, generator=g)


def _zoo_raw(key: str) -> bool:
    """A raw parameter of a caption-zoo decoder (`caption_model.i2h_w`),
    as against a layer's entry (`caption_model.fc_embed.weight`)."""
    return key.startswith(CAPTION_PREFIX) and \
        "." not in key[len(CAPTION_PREFIX):]


def _initializer(key: str, cfg: Config):
    """The flax default that `engine/train_state.py::init_params` gives
    the JAX counterpart of the state_dict entry `key`."""
    leaf = key.rsplit(".", 1)[-1]
    if ".bn" in key or ".downsample.1." in key or "_bn." in key:
        # frozen BN (MobileNetV1's `stem_bn`, `dw_bn`, `pw_bn` too): identity
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
    if key in ("caption_model.embed.0.weight", "caption_model.embed_w"):
        return _normal(0.01)
    if _zoo_raw(key):
        if leaf == "b" or leaf.endswith("_b"):
            return lambda shape, g: torch.zeros(shape)
        return _lecun_normal_in_out
    if key.startswith(("rpn_", "cls_score_net", "mask_")):
        return _normal(0.01)
    if key.startswith("bbox_pred_net"):
        return _normal(0.001)
    # mlp, dynamic_fc*, response_fc, the captioner's layers, att_head
    return _lecun_normal


def _draw(shapes: Dict[str, Tuple[int, ...]], cfg: Config, seed: int
          ) -> Dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    return OrderedDict((k, _initializer(k, cfg)(shape, g).float())
                       for k, shape in shapes.items())


def init_params(cfg: Config, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Full state_dict for `Lang2Seg(cfg)`, on the CPU, drawn from
    torch.Generator(seed) in the module's key order."""
    return _draw(state_dict_shapes(cfg), cfg, seed)


def init_captioner_params(cfg: Config, seed: int = 0
                          ) -> Dict[str, torch.Tensor]:
    """The `caption_model.*` entries of a state_dict for the captioner of
    cfg.model alone (captioner pretraining), drawn as init_params draws
    them, from torch.Generator(seed) in the module's key order."""
    from .models.caption_zoo import setup_captioner
    with torch.device("meta"):
        sd = setup_captioner(cfg.model).state_dict()
    return _draw({f"caption_model.{k}": tuple(v.shape) for k, v in sd.items()},
                 cfg, seed)


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


def _vgg(out, p):
    for idx, name in VGG_FEATURES.items():
        out[f"vgg.features.{idx}.weight"] = _conv(p[name]["kernel"])
        out[f"vgg.features.{idx}.bias"] = _t(p[name]["bias"])
    # JAX fc6 reads the crop flattened (7, 7, C); the reference (C, 7, 7)
    w6 = np.asarray(p["fc6"]["kernel"]).T                  # (O, 7 * 7 * C)
    o = w6.shape[0]
    out["vgg.classifier.0.weight"] = _t(
        w6.reshape(o, 7, 7, -1).transpose(0, 3, 1, 2).reshape(o, -1))
    out["vgg.classifier.0.bias"] = _t(p["fc6"]["bias"])
    out["vgg.classifier.3.weight"] = _lin(p["fc7"]["kernel"])
    out["vgg.classifier.3.bias"] = _t(p["fc7"]["bias"])


def _mobilenet(out, p):
    out["mobilenet.stem.weight"] = _conv(p["stem"]["kernel"])
    _bn(out, "mobilenet.stem_bn", p["stem_bn"])
    names = [f"block{i}" for i in range(len(BLOCKS_HEAD))] + \
        [f"tail{i}" for i in range(len(BLOCKS_TAIL))]
    for name in names:
        for part in ("dw", "pw"):
            out[f"mobilenet.{name}.{part}.weight"] = _conv(
                p[name][part]["kernel"])
            _bn(out, f"mobilenet.{name}.{part}_bn", p[name][f"{part}_bn"])


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


def _captioner(out, p):
    pre = CAPTION_PREFIX
    if "a2c_w" not in p:
        # a zoo decoder: raw params as they are, the Dense layers as Linear
        for k, v in p.items():
            if isinstance(v, dict):
                out[f"{pre}{k}.weight"] = _lin(v["kernel"])
                out[f"{pre}{k}.bias"] = _t(v["bias"])
            else:
                out[pre + k] = _t(v)
        return
    out[pre + "embed.0.weight"] = _t(p["embed_w"])
    for layer in ("fc_embed", "att_embed", "ctx2att"):
        name = pre + layer + (".0" if layer.endswith("embed") else "")
        out[f"{name}.weight"] = _lin(p[layer]["kernel"])
        out[f"{name}.bias"] = _t(p[layer]["bias"])
    for raw, layer in (("logit", "logit"), ("i2h", "core.i2h"),
                       ("h2h", "core.h2h"), ("a2c", "core.a2c"),
                       ("h2att", "core.attention.h2att"),
                       ("alpha", "core.attention.alpha_net")):
        out[f"{pre}{layer}.weight"] = _lin(p[f"{raw}_w"])
        out[f"{pre}{layer}.bias"] = _t(p[f"{raw}_b"])


def captioner_from_jax(params) -> Dict[str, torch.Tensor]:
    """The captioner's JAX params subtree -> its `caption_model.*`
    entries."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    _captioner(out, params)
    return out


def from_jax_params(params, cfg: Config) -> Dict[str, torch.Tensor]:
    """JAX params tree (nested dicts of arrays, as `init_params` of the
    JAX package returns after `jax.device_get`) -> the port's state_dict.
    A subtree the tree lacks (a captioner-only checkpoint has just
    `captioner`) leaves its entries out."""
    m = cfg.model
    out: Dict[str, torch.Tensor] = OrderedDict()
    if "backbone" in params:
        if m.backbone == "vgg16":
            _vgg(out, params["backbone"])
        elif m.backbone == "mobilenet_v1":
            _mobilenet(out, params["backbone"])
        else:
            _resnet(out, params["backbone"], m.backbone)
    if "encoder" in params:
        _encoder(out, params["encoder"])
    if "filter_gen" in params:
        _filters(out, params["filter_gen"], m.num_filters, m.c4_feat_dim)
    if "rpn_head" in params:
        _rpn(out, params["rpn_head"],
             len(m.anchor_scales) * len(m.anchor_ratios))
    if "box_head" in params:
        _heads(out, params)
    if "captioner" in params:
        _captioner(out, params["captioner"])
    if "att_head" in params:
        out["att_head.weight"] = _lin(params["att_head"]["kernel"])
        out["att_head.bias"] = _t(params["att_head"]["bias"])
    return out


def state_dict_shapes(cfg: Config) -> Dict[str, Tuple[int, ...]]:
    """Key -> shape of the port's state_dict, without allocating it."""
    from .models.network import Lang2Seg
    with torch.device("meta"):
        return {k: tuple(v.shape)
                for k, v in Lang2Seg(cfg).state_dict().items()}
