"""Lang2Seg serving path: the language-conditioned Mask R-CNN at test time.

Counterpart of `lang2seg_tpu/models/network.py::Lang2Seg` (`test_forward`,
`predict_masks`, `_roi_features`). Expressions are the batch axis; an
image's C4 map is computed once and broadcast (stride 0, no copy) over
its expressions. The state_dict carries the reference network's keys
(`resnet.*`, `rnn_encoder.*`, `dynamic_fc_0..6`, `response_fc`,
`rpn_net`, `cls_score_net`, `mask_up_sampling`, ...), so the JAX
package's `engine/convert.py::convert_torch_state_dict` maps it onto the
JAX params tree.

Ported: ResNet backbones, the language path, `num_filters` 1 or 7, both
gates, test mode 'nms', pooling mode 'crop'. The rest (VGG, MobileNet,
no-language mode, 'top' proposals, 'pool' crops, captioner, training)
raises NotImplementedError here.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import Config
from ..device import resolve_device
from ..ops.anchors import shifted_anchors
from ..ops.proposals import proposal_layer
from ..ops.roi_align import roi_crop_pool
from .dynamic_filter import DynamicFilterGen
from .heads import BoxHead, MaskHead, RPNHead
from .lang_encoder import RNNEncoder
from .resnet import ResNetC4


class Lang2Seg(nn.Module):
    """Construct with a full `Config`."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        m = cfg.model
        if not m.backbone.startswith("resnet"):
            raise NotImplementedError(f"backbone {m.backbone!r} is not ported")
        if not m.use_language:
            raise NotImplementedError("no-language mode is not ported")
        if m.use_caption_loss or m.use_attribute_head:
            raise NotImplementedError("captioner / attribute head not ported")
        self.compute_dtype = (torch.bfloat16 if m.compute_dtype == "bfloat16"
                              else torch.float32)
        self.resnet = ResNetC4(m.backbone, self.compute_dtype)
        self.rnn_encoder = RNNEncoder(
            m.vocab_size, m.word_embedding_size, m.word_vec_size,
            m.rnn_hidden_size, m.bidirectional, m.word_drop_out)
        hidden = m.rnn_hidden_size * (2 if m.bidirectional else 1)
        num_anchors = len(m.anchor_scales) * len(m.anchor_ratios)
        # The heads group layers that the reference keeps at the top level
        # of its state_dict: their layers are registered here under their
        # own names, and the heads are kept as plain attributes.
        self._set_head("filter_gen", DynamicFilterGen(
            hidden, m.c4_feat_dim, m.num_filters, m.response_gate,
            m.normalize_response))
        self._set_head("rpn_head", RPNHead(m.c4_feat_dim, num_anchors))
        self._set_head("box_head", BoxHead(2048, m.num_classes))
        if m.use_mask_head:
            self._set_head("mask_head", MaskHead(2048, m.num_classes))

    def _set_head(self, name: str, head: nn.Module) -> None:
        for child_name, child in head.named_children():
            self.add_module(child_name, child)
        object.__setattr__(self, name, head)

    # ---------- building blocks ----------

    def _condition(self, net_conv: torch.Tensor, labels: torch.Tensor):
        """Language encoding + dynamic-filter gating.
        net_conv: (E, h, w, C); labels: (E, T)."""
        _, hidden, _ = self.rnn_encoder(labels)
        return self.filter_gen(net_conv, hidden)

    def _roi_features(self, gated: torch.Tensor, rois: torch.Tensor
                      ) -> torch.Tensor:
        """gated: (E, h, w, C); rois: (E, R, 4) in scaled-image coords.
        Returns spatial_fc7 (E, R, 7, 7, 2048)."""
        m = self.cfg.model
        if m.pooling_mode != "crop":
            raise NotImplementedError("pooling_mode 'pool' is not ported")
        crops = roi_crop_pool(gated, rois, m.pooling_size,
                              1.0 / m.feat_stride, m.max_pool)
        e, r = crops.shape[:2]
        fc7 = self.resnet.tail(crops.reshape(e * r, *crops.shape[2:]))
        return fc7.reshape(e, r, *fc7.shape[1:])

    def _images(self, images: torch.Tensor) -> torch.Tensor:
        if images.dtype == torch.uint8:
            # uint8 wire format: raw BGR, mean subtraction on the device
            means = torch.tensor(self.cfg.data.pixel_means_bgr,
                                 dtype=torch.float32, device=images.device)
            return images.float() - means
        return images.float()

    # ---------- inference ----------

    @torch.no_grad()
    def test_forward(self, batch: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Single-image, batched-expression inference.

        batch: images (1, H, W, 3), im_hw (1, 2), labels (E, T), all on
        the model's device. Returns per-expression rois / scores / boxes
        and the gated conv map for the follow-up mask prediction
        (reference test_image, network.py:625-642)."""
        cfg, m, ts = self.cfg, self.cfg.model, self.cfg.test
        if ts.mode != "nms":
            raise NotImplementedError("test mode 'top' is not ported")
        labels = batch["labels"]
        e = labels.shape[0]
        net_conv_img = self.resnet.head(self._images(batch["images"]))
        net_conv = net_conv_img.contiguous().expand(
            e, *net_conv_img.shape[1:])
        gated, response = self._condition(net_conv, labels)
        rpn_cls, rpn_box = self.rpn_head(gated)
        _, h, w, a, _ = rpn_cls.shape
        anchors = shifted_anchors(h, w, m.feat_stride, m.anchor_scales,
                                  m.anchor_ratios, device=gated.device)
        n = anchors.shape[0]
        hw = batch["im_hw"][0].float()
        score_pos = torch.softmax(rpn_cls.reshape(e, n, 2), dim=-1)[..., 1]
        props = proposal_layer(score_pos, rpn_box.reshape(e, n, 4), anchors,
                               hw[0], hw[1], ts.rpn_pre_nms_top_n,
                               ts.rpn_post_nms_top_n, ts.rpn_nms_thresh)
        spatial_fc7 = self._roi_features(gated, props.rois)
        r = spatial_fc7.shape[1]
        cls_score, bbox_pred = self.box_head(
            spatial_fc7.reshape(e * r, *spatial_fc7.shape[2:]))
        cls_score = cls_score.reshape(e, r, -1)
        cls_prob = torch.softmax(cls_score, dim=-1)
        bbox_pred = bbox_pred.reshape(e, r, m.num_classes, 4)
        # de-normalize deltas (network.py:607-613)
        stds = torch.tensor(cfg.train.bbox_normalize_stds,
                            dtype=torch.float32, device=gated.device)
        means = torch.tensor(cfg.train.bbox_normalize_means,
                             dtype=torch.float32, device=gated.device)
        bbox_pred = bbox_pred * stds + means
        return {"rois": props.rois, "roi_valid": props.valid,
                "cls_score": cls_score, "cls_prob": cls_prob,
                "bbox_pred": bbox_pred.reshape(e, r, -1),
                "gated_conv": gated, "response": response}

    @torch.no_grad()
    def predict_masks(self, gated_conv: torch.Tensor, boxes: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
        """Mask probs for given boxes and classes (reference
        _predict_masks_from_boxes_and_labels, network.py:550-581).

        gated_conv: (E, h, w, C); boxes: (E, B, 4) scaled coords; labels:
        (E, B) int class ids. Returns (E, B, S, S) in [0, 1]."""
        s = self.cfg.model.mask_size
        fc7 = self._roi_features(gated_conv, boxes)
        e, b = fc7.shape[:2]
        sel = self.mask_head(fc7.reshape(e * b, *fc7.shape[2:]),
                             labels=labels.reshape(e * b))
        return torch.sigmoid(sel.reshape(e, b, s, s))


def build_model(cfg: Config, device="cuda", state_dict=None,
                seed: int = 0) -> Lang2Seg:
    """The serving model on `device` (default the card; raises without
    one), in eval mode, with channels_last conv weights. Weights come from
    `state_dict` (reference keys; see weights.from_jax_params) or, when
    None, from weights.init_params(cfg, seed)."""
    from ..weights import init_params
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Lang2Seg(cfg)
    model = model.to_empty(device=dev)
    if state_dict is None:
        state_dict = init_params(cfg, seed)
    model.load_state_dict(state_dict, strict=True)
    return model.eval().to(memory_format=torch.channels_last)
