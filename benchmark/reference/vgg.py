"""The plain reference of the detection-only VGG16 network (the `vgg`
configuration), in float32.

VGG16 (Simonyan & Zisserman, arXiv:1409.1556) as the backbone of Faster
R-CNN (Ren et al., arXiv:1506.01497), conditioned on a referring
expression as in Chen et al. (arXiv:1910.04748): the reference repo's
`nets/vgg16.py:43-89`, trained by `tools/train_vgg.py` (C4 512). The head
is torchvision's vgg16 `features` without its last max-pool (13 3 x 3
convolutions with bias and ReLU, four 2 x 2 max-pools, stride 16, 512
channels); the bi-LSTM, the seven dynamic filters with the sigmoid gate,
the RPN, NMS, the 7 x 7 crop, the samplers, the losses and SGD are
`model.py`'s plain parts at C = 512; the tail flattens each crop
channel-major, (512, 7, 7), as fc6 reads it, and runs fc6 (4096) + ReLU +
dropout, fc7 (4096) + ReLU + dropout; the box head reads those 4096
features. No mask head, no mask loss. conv1_* and conv2_* are frozen (the
first ten feature layers, `nets/vgg16.py:48-50`); there is no BatchNorm,
so `frozen_statistics` sets nothing.

Departures from `nets/vgg16.py`, each the measured program's too:
* dropout draws its masks from the caller's generator, in the program's
  order (word dropout, anchor priorities, ROI priorities, fc6's mask, then
  fc7's), not from torch's global RNG;
* the ROI features are the 7 x 7 bilinear crop without the reference's
  2 x 2 max-pool after a 14 x 14 crop (the configuration's `max_pool`
  false), as `model.py` crops;
* a step trains 16 expressions over 2 images at once, where the reference
  repo takes one optimizer step a sentence.

`precision` "fp8" (the control) rounds every product's operands as
`model.py`'s `Precision` does. It imports nothing of the program, of its
JAX original or of JAX.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from . import model as _model
from .model import (BoxHead, Conv2d, DynamicFilterGen, Linear, Precision,
                    RNNEncoder, RPNHead, anchor_targets, bce_with_logits,
                    crop_and_resize, namespace, proposal_layer,
                    proposal_targets, response_target, shifted_anchors,
                    smooth_l1, unpack_bits, weighted_ce, word_dropout)
# re-exported: the functions every reference module provides
from .model import (PlainSGD, crop_gather, param_groups,  # noqa: F401
                    paste_iou, select_boxes)

# (convs, channels) of conv1 .. conv5; a 2 x 2 max-pool follows each but
# conv5
STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# `features` indices of conv1_* and conv2_*, which the reference freezes
FROZEN_FEATURES = (0, 2, 5, 7)
FC_DIM = 4096


class VGG16(nn.Module):
    """torchvision's layer indices, so that the keys are
    `vgg.features.{0,2,5,...,28}` and `vgg.classifier.{0,3}`; the
    classifier's ReLU and dropout slots hold no parameters and are
    applied in `tail`, at torchvision's rate of 0.5."""

    def __init__(self, drop_rate: float = 0.5):
        super().__init__()
        self.drop_rate = drop_rate
        layers, cin = [], 3
        for si, (n, ch) in enumerate(STAGES):
            for _ in range(n):
                layers += [Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
                cin = ch
            if si < len(STAGES) - 1:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            Linear(512 * 7 * 7, FC_DIM), nn.ReLU(), nn.Identity(),
            Linear(FC_DIM, FC_DIM), nn.ReLU(), nn.Identity())

    def head(self, images):                      # (B, H, W, 3) -> NHWC C4
        return self.features(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def tail(self, crops, generator=None):       # (R, 7, 7, 512) NHWC
        x = crops.permute(0, 3, 1, 2).reshape(crops.shape[0], -1)
        for fc in (self.classifier[0], self.classifier[3]):
            x = F.relu(fc(x))
            if self.training and self.drop_rate > 0.0:
                x = word_dropout(x, self.drop_rate, generator)
        return x.reshape(x.shape[0], 1, 1, FC_DIM)


class Reference(nn.Module):
    """The network under the measured program's state-dict keys. `cfg` is
    the nested dict of a configuration file's `config`."""

    def __init__(self, cfg: Dict, precision: str = "float32"):
        super().__init__()
        self.cfg = c = namespace(cfg)
        m = c.model
        if m.backbone != "vgg16" or m.use_mask_head or \
                m.pooling_mode != "crop" or m.num_filters != 7 or \
                c.test.mode != "nms":
            raise ValueError("this reference covers VGG16 with the crop, "
                             "seven filters, no mask head and test mode "
                             "'nms'")
        self.prec = Precision(precision)
        self.vgg = VGG16()
        self.rnn_encoder = RNNEncoder(m)
        self.filter_gen = DynamicFilterGen(m)
        a = len(m.anchor_scales) * len(m.anchor_ratios)
        self.rpn = RPNHead(m.c4_feat_dim, a)
        self.box = BoxHead(FC_DIM, m.num_classes)
        self.crop = crop_and_resize
        for mod in self.modules():
            if mod is not self:
                mod.prec = self.prec

    # the state-dict keys, the image means, the RPN and box outputs on a
    # gated map and the whole test-mode forward are the ResNet network's,
    # on this network's parts
    reference_state_keys = _model.Reference.reference_state_keys
    load_reference_state = _model.Reference.load_reference_state
    _images = _model.Reference._images
    rpn_outputs = _model.Reference.rpn_outputs
    box_outputs = _model.Reference.box_outputs
    test_forward = _model.Reference.test_forward

    def set_frozen(self) -> None:
        """requires_grad off for conv1_* and conv2_*."""
        for idx in FROZEN_FEATURES:
            for p in self.vgg.features[idx].parameters():
                p.requires_grad_(False)

    def roi_tail(self, gated, rois, generator=None):
        m = self.cfg.model
        crops = self.crop(gated, rois, m.pooling_size, 1.0 / m.feat_stride)
        e, r = crops.shape[:2]
        fc7 = self.vgg.tail(crops.reshape(e * r, *crops.shape[2:]),
                            generator)
        return fc7.reshape(e, r, *fc7.shape[1:])

    # ---------------- serving ----------------

    @torch.no_grad()
    def condition(self, images, labels):
        """(net_conv (N, h, w, C), gated (E, h, w, C), response (E, h, w,
        1)) for N images of E // N expressions each."""
        net_conv = self.vgg.head(self._images(images))
        hidden = self.rnn_encoder(labels)
        gated, response = self.filter_gen(
            net_conv, hidden, labels.shape[0] // net_conv.shape[0])
        return net_conv, gated, response

    def mask_probs(self, gated, boxes, labels):
        raise NotImplementedError("the vgg network is detection-only: it has "
                                  "no mask head")

    # ---------------- training ----------------

    def train_forward(self, batch, generator, proposals=None):
        """The losses of one batch: the RPN's, the box head's and the
        response's. `proposals` (rois, valid) stands in for the RPN's NMS
        output (the program's discrete choice, which the check follows);
        None runs the reference's own."""
        c = self.cfg
        m, t = c.model, c.train
        images = self._images(batch["images"])
        img_idx = batch["img_idx"].long()
        e = img_idx.shape[0]
        gt_boxes = batch["gt_boxes"].float()
        if gt_boxes.dim() == 2:
            gt_boxes = gt_boxes[:, None, :]
        gt_masks = batch["gt_masks"]
        if gt_masks.dim() == 3:
            gt_masks = gt_masks[:, None]
        if gt_masks.shape[-1] * 8 == images.shape[2]:
            gt_masks = unpack_bits(gt_masks)
        gt_valid = torch.ones(gt_boxes.shape[:2], dtype=torch.bool,
                              device=gt_boxes.device)
        net_conv = self.vgg.head(images).index_select(0, img_idx)
        hidden = self.rnn_encoder(batch["labels"], generator)
        gated, response = self.filter_gen(net_conv, hidden)
        rpn_cls, rpn_box = self.rpn(gated)
        _, h, w, a, _ = rpn_cls.shape
        n = h * w * a
        anchors = shifted_anchors(h, w, m.feat_stride, m.anchor_scales,
                                  m.anchor_ratios, gated.device)
        im_hw = batch["im_hw"].float().index_select(0, img_idx)
        at = anchor_targets(anchors, gt_boxes, gt_valid, im_hw[:, 0],
                            im_hw[:, 1], generator, t)
        if proposals is None:
            with torch.no_grad():
                sp = torch.softmax(rpn_cls.reshape(e, n, 2), -1)[..., 1]
                props = proposal_layer(sp, rpn_box.reshape(e, n, 4), anchors,
                                       im_hw[:, 0], im_hw[:, 1],
                                       t.rpn_pre_nms_top_n,
                                       t.rpn_post_nms_top_n, t.rpn_nms_thresh)
            proposals = (props.rois, props.valid)
            if getattr(self, "_capture", None) is not None:
                self._capture.update(
                    score_pos=sp, deltas=rpn_box.detach().reshape(e, n, 4),
                    anchors=anchors, im_h=im_hw[:, 0], im_w=im_hw[:, 1],
                    rois=props.rois, valid=props.valid)
        rois, lab, btgt, bw, _, _, rvalid = proposal_targets(
            proposals[0], proposals[1], gt_boxes, gt_valid,
            gt_masks.to(torch.uint8), generator, t, m.mask_size)
        labels_a, tgt_a, in_a, out_a = at
        losses = {
            "rpn_cross_entropy": weighted_ce(
                rpn_cls.reshape(e, n, 2), torch.clamp(labels_a, min=0),
                (labels_a >= 0).float()),
            "rpn_loss_box": torch.sum(smooth_l1(
                rpn_box.reshape(e, n, 4), tgt_a, in_a[..., None],
                out_a[..., None], 3.0)) / e}
        fc7 = self.roi_tail(gated, rois, generator)
        r = fc7.shape[1]
        cls_score, bbox_pred = self.box(fc7.reshape(e * r, *fc7.shape[2:]))
        losses["cross_entropy"] = weighted_ce(cls_score.reshape(e, r, -1),
                                              lab, rvalid.float())
        sel = torch.gather(bbox_pred.reshape(e, r, m.num_classes, 4), 2,
                           lab[..., None, None].expand(e, r, 1, 4))[:, :, 0]
        losses["loss_box"] = torch.sum(smooth_l1(
            sel, btgt, bw[..., None], bw[..., None], 1.0)) / (e * r)
        if m.use_response_loss:
            stride = m.feat_stride
            tgt = response_target(gt_masks[:, 0], stride, h, w)
            ys = torch.arange(h, device=gated.device)[None, :, None] * stride
            xs = torch.arange(w, device=gated.device)[None, None, :] * stride
            vmask = ((ys < im_hw[:, 0, None, None])
                     & (xs < im_hw[:, 1, None, None])).float()
            rb = bce_with_logits(response[..., 0], tgt)
            losses["loss_response"] = torch.sum(rb * vmask) / torch.clamp(
                torch.sum(vmask), min=1.0)
        losses["total_loss"] = sum(losses.values())
        return losses


def frozen_statistics(sd: Dict, cfg: Dict, seed: int, device) -> None:
    """VGG16 has no BatchNorm: nothing in the drawn weights is set."""
