"""Lang2Seg: the language-conditioned Mask R-CNN, for serving and training.

Counterpart of `lang2seg_tpu/models/network.py::Lang2Seg` (`train_forward`
with its losses, `test_forward`, `predict_masks`, `_roi_features`).
Expressions are the batch axis. In serving an image's C4 map is computed
once and broadcast (stride 0, no copy) over its expressions; in training
each expression gathers its image's map (`img_idx`), and the gather's
backward sums the expressions' gradients per image. The state_dict
carries the reference network's keys (`resnet.*` or `vgg.*`,
`rnn_encoder.*`, `dynamic_fc_0..6`, `response_fc`, `rpn_net`,
`cls_score_net`, `mask_up_sampling`, ...), so the JAX package's
`engine/convert.py::convert_torch_state_dict` maps it onto the JAX params
tree.

Ported: the ResNet backbones and VGG16 (the detection-only `vgg` variant:
C4 512, a 4096-wide fc6/fc7 tail, no mask head), the language path,
`num_filters` 1 or 7, both gates, test modes 'nms' and 'top', pooling
mode 'crop', the detection, mask and response losses, the
caption-consistency loss of the `cycle` and `cycle_response` variants
(the att2in2 captioner, `caption_model.*`), and the no-language plain
Mask R-CNN of the `pretrain` variant (no `rnn_encoder` / `dynamic_fc*` /
`response_fc`; the backbone map goes straight to the RPN, each example
an image with up to M GT boxes and masks), which trains but, as in the
JAX package, cannot be served, and the attribute head (`att_head`: a
multi-label BCE on the un-gated map cropped at each expression's GT box,
`predict_attribute_scores`). The rest (MobileNet, 'pool' crops,
`expr_uid` key folding) raises NotImplementedError here.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..device import device_constant, resolve_device
from ..ops.anchors import shifted_anchors
from ..ops.proposals import proposal_layer, proposal_top_layer
from ..ops.roi_align import roi_crop_pool
from ..ops.targets import anchor_targets, proposal_targets
from .caption_zoo import setup_captioner
from .dynamic_filter import DynamicFilterGen
from .heads import BoxHead, MaskHead, RPNHead
from .lang_encoder import RNNEncoder
from .resnet import ResNetC4
from .vgg import VGG16


def smooth_l1(pred, target, inside_w, outside_w, sigma: float):
    """Reference _smooth_l1_loss (network.py:357-370): per-element huber on
    inside-weighted diffs, scaled by outside weights; the caller reduces.
    Masked entries are selected away (not multiplied by 0), so an inf
    outside the mask cannot make the loss NaN."""
    s2 = sigma * sigma
    diff = torch.where(inside_w > 0, pred - target, 0.0) * inside_w
    a = torch.abs(diff)
    flag = (a < 1.0 / s2).to(pred.dtype)
    per = flag * 0.5 * s2 * diff * diff + (1.0 - flag) * (a - 0.5 / s2)
    return torch.where(outside_w > 0, per * outside_w, 0.0)


def weighted_softmax_ce(logits, labels, weights):
    """Mean cross entropy over the entries with weight > 0:
    sum(w * ce) / max(sum(w), 1)."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    ce = torch.where(weights > 0, ce, 0.0)
    return torch.sum(ce * weights) / torch.clamp(torch.sum(weights), min=1.0)


def response_target(gt_mask: torch.Tensor, stride: int, h: int,
                    w: int) -> torch.Tensor:
    """Nearest-downsample (..., canvas_h, canvas_w) GT masks to the (h, w)
    response map by stride-center sampling: cell k reads canvas pixel
    stride * k + stride // 2 (the JAX package's `response_target`)."""
    gm = gt_mask.float()
    return gm[..., stride // 2::stride, stride // 2::stride][..., :h, :w]


def bce_with_logits(logits, targets):
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def unpack_mask_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., W // 8) uint8 masks bit-packed MSB-first along the width
    (np.packbits(_, axis=-1)) -> (..., W) uint8 {0, 1}."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


class Lang2Seg(nn.Module):
    """Construct with a full `Config`."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        m = cfg.model
        if not (m.backbone.startswith("resnet") or m.backbone == "vgg16"):
            raise NotImplementedError(f"backbone {m.backbone!r} is not ported")
        self.compute_dtype = (torch.bfloat16 if m.compute_dtype == "bfloat16"
                              else torch.float32)
        # the reference names the backbone `vgg` or `resnet`; `backbone`
        # reaches either
        if m.backbone == "vgg16":
            self.vgg = VGG16(self.compute_dtype)
            self.vgg.freeze()
            tail_dim = 4096
        else:
            self.resnet = ResNetC4(m.backbone, self.compute_dtype)
            self.resnet.freeze(m.fixed_blocks)
            tail_dim = 2048
        # The heads group layers that the reference keeps at the top level
        # of its state_dict: their layers are registered here under their
        # own names, and the heads are kept as plain attributes.
        if m.use_language:
            self.rnn_encoder = RNNEncoder(
                m.vocab_size, m.word_embedding_size, m.word_vec_size,
                m.rnn_hidden_size, m.bidirectional, m.word_drop_out)
            hidden = m.rnn_hidden_size * (2 if m.bidirectional else 1)
            self._set_head("filter_gen", DynamicFilterGen(
                hidden, m.c4_feat_dim, m.num_filters, m.response_gate,
                m.normalize_response))
        num_anchors = len(m.anchor_scales) * len(m.anchor_ratios)
        self._set_head("rpn_head", RPNHead(m.c4_feat_dim, num_anchors))
        self._set_head("box_head", BoxHead(tail_dim, m.num_classes))
        if m.use_mask_head:
            self._set_head("mask_head", MaskHead(tail_dim, m.num_classes))
        if m.use_caption_loss:
            self.caption_model = setup_captioner(m)
        if m.use_attribute_head:
            # multi-label attribute scores from pooled ROI features
            # (MAttNet's attribute branch, eval_easy_utils.py:54-57)
            self.att_head = nn.Linear(tail_dim, m.num_attributes)

    def _set_head(self, name: str, head: nn.Module) -> None:
        for child_name, child in head.named_children():
            self.add_module(child_name, child)
        object.__setattr__(self, name, head)

    @property
    def backbone(self) -> nn.Module:
        """The `ResNetC4` or `VGG16` (`head`, `tail`)."""
        return self.vgg if self.cfg.model.backbone == "vgg16" else self.resnet

    # ---------- building blocks ----------

    def _condition(self, net_conv: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """Language encoding + dynamic-filter gating.
        net_conv: (E, h, w, C); labels: (E, T); `generator` draws the
        word-dropout mask in train mode."""
        _, hidden, _ = self.rnn_encoder(labels, generator)
        return self.filter_gen(net_conv, hidden)

    def _roi_features(self, gated: torch.Tensor, rois: torch.Tensor,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """gated: (E, h, w, C); rois: (E, R, 4) in scaled-image coords.
        Returns spatial_fc7 (E, R, 7, 7, 2048) (ResNet) or (E, R, 1, 1,
        4096) (VGG16, whose tail draws its dropout masks from `generator`
        in train mode)."""
        m = self.cfg.model
        if m.pooling_mode != "crop":
            raise NotImplementedError("pooling_mode 'pool' is not ported")
        crops = roi_crop_pool(gated, rois, m.pooling_size,
                              1.0 / m.feat_stride, m.max_pool)
        e, r = crops.shape[:2]
        flat = crops.reshape(e * r, *crops.shape[2:])
        if m.backbone == "vgg16":
            fc7 = self.vgg.tail(flat, generator)
        else:
            fc7 = self.resnet.tail(flat)
        return fc7.reshape(e, r, *fc7.shape[1:])

    def _gt_masks(self, gt_masks: torch.Tensor, canvas_w: int
                  ) -> torch.Tensor:
        """(E, M, Hc, Wc) uint8 {0, 1} GT masks from the batch's (E, M, ...)
        or (E, ...) masks, bit-packed along the width when
        cfg.data.wire_packed_masks and the width is canvas_w / 8."""
        if gt_masks.dim() == 3:
            gt_masks = gt_masks[:, None]
        if self.cfg.data.wire_packed_masks and \
                gt_masks.shape[-1] * 8 == canvas_w:
            return unpack_mask_bits(gt_masks)
        if gt_masks.shape[-1] != canvas_w:
            raise ValueError(
                f"gt_masks width {gt_masks.shape[-1]} is neither the canvas "
                f"width {canvas_w} nor its bit-packed form (with "
                f"cfg.data.wire_packed_masks="
                f"{self.cfg.data.wire_packed_masks})")
        return gt_masks

    def _images(self, images: torch.Tensor) -> torch.Tensor:
        if images.dtype == torch.uint8:
            # uint8 wire format: raw BGR, mean subtraction on the device
            means = device_constant(self.cfg.data.pixel_means_bgr,
                                    images.device)
            return images.float() - means
        return images.float()

    # ---------- training ----------

    def train_forward(self, batch: Dict[str, torch.Tensor],
                      targets: Optional[Tuple] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """Losses of one training batch; every tensor on the model's device.

        batch:
          images   (I, H, W, 3) f32 mean-subtracted BGR, or the raw uint8
                   BGR canvas (the means are subtracted here)
          im_hw    (I, 2) f32 true scaled extents
          labels   (E, T) int token ids, 0 pad (language mode only)
          img_idx  (E,) int image index per example
          gt_boxes (E, M, 5) f32 [x1 y1 x2 y2 cls] scaled coords, or (E, 5)
          gt_valid (E, M) bool, optional (default all valid)
          gt_masks (E, M, Hc, Wc) uint8 {0, 1} canvas masks (or (E, Hc,
                   Wc)), or bit-packed along the width when
                   cfg.data.wire_packed_masks and Hc x Wc / 8
          cap_labels (E, T') int BOS/EOS-framed caption tokens and
          cap_masks  (E, T') f32 (`data/loader.py::caption_targets`),
                   with cfg.model.use_caption_loss
          att_labels (E, A) f32 multi-hot attribute words and
          att_valid  (E,) bool, optional (default all valid), with
                   cfg.model.use_attribute_head (no `loss_att` without
                   att_labels)
        In language mode each example is an expression with its one GT
        ref (M = 1); without language (`pretrain`) an example is an image
        with its padded GT set, and the backbone map feeds the RPN as it
        is (no response or caption loss).
        `targets` injects (AnchorTargets, ProposalTargets), either of them
        None to compute it, as the JAX package's train_forward does.
        `generator` draws, in this order: the word-dropout mask (with
        language), the anchor sampling priorities, the ROI sampling
        priorities, then VGG16's fc6 and fc7 dropout masks (the `vgg`
        variant; those of the attribute head's GT crops next), then the
        captioner's dropout masks (and its scheduled-sampling draws).
        Returns the loss dict with `total_loss`, all scalars on the
        device."""
        m, t = self.cfg.model, self.cfg.train
        if "expr_uid" in batch:
            raise NotImplementedError(
                "expr_uid key folding is not ported (it comes with data "
                "parallel training)")
        images = self._images(batch["images"])
        img_idx = batch["img_idx"].long()
        e = img_idx.shape[0]
        gt_boxes = batch["gt_boxes"].float()
        if gt_boxes.dim() == 2:
            gt_boxes = gt_boxes[:, None, :]
        gt_masks = self._gt_masks(batch["gt_masks"], images.shape[2])
        gt_valid = batch.get("gt_valid")
        if gt_valid is None:
            gt_valid = torch.ones(gt_boxes.shape[:2], dtype=torch.bool,
                                  device=gt_boxes.device)

        net_conv_img = self.backbone.head(images)             # (I, h, w, C)
        net_conv = net_conv_img.index_select(0, img_idx).contiguous()
        if m.use_language:
            gated, response = self._condition(net_conv, batch["labels"],
                                              generator)
        else:
            gated, response = net_conv, None
        rpn_cls, rpn_box = self.rpn_head(gated)               # (E,h,w,A,2|4)
        _, h, w, a, _ = rpn_cls.shape
        anchors = shifted_anchors(h, w, m.feat_stride, m.anchor_scales,
                                  m.anchor_ratios, device=gated.device)
        n = anchors.shape[0]
        im_hw = batch["im_hw"].float().index_select(0, img_idx)   # (E, 2)

        at, pt = targets if targets is not None else (None, None)
        if at is None:
            at = anchor_targets(
                anchors, gt_boxes, gt_valid, im_hw[:, 0], im_hw[:, 1],
                generator=generator, rpn_batchsize=t.rpn_batchsize,
                fg_fraction=t.rpn_fg_fraction,
                pos_overlap=t.rpn_positive_overlap,
                neg_overlap=t.rpn_negative_overlap,
                clobber_positives=t.rpn_clobber_positives)
        if pt is None:
            with torch.no_grad():
                score_pos = torch.softmax(rpn_cls.reshape(e, n, 2),
                                          dim=-1)[..., 1]
                props = proposal_layer(
                    score_pos, rpn_box.reshape(e, n, 4), anchors,
                    im_hw[:, 0], im_hw[:, 1], t.rpn_pre_nms_top_n,
                    t.rpn_post_nms_top_n, t.rpn_nms_thresh)
            pt = proposal_targets(
                props.rois, props.valid, gt_boxes, gt_valid,
                gt_masks.to(torch.uint8), generator=generator,
                num_rois=t.roi_batch_size, fg_fraction=t.fg_fraction,
                fg_thresh=t.fg_thresh, bg_thresh_hi=t.bg_thresh_hi,
                bg_thresh_lo=t.bg_thresh_lo, mask_size=m.mask_size,
                normalize_means=t.bbox_normalize_means,
                normalize_stds=t.bbox_normalize_stds, use_gt=t.use_gt)

        # ---- RPN losses (network.py:372-387) ----
        rpn_ce = weighted_softmax_ce(
            rpn_cls.reshape(e, n, 2), torch.clamp(at.labels, min=0),
            (at.labels >= 0).float())
        rpn_l1 = smooth_l1(rpn_box.reshape(e, n, 4), at.bbox_targets,
                           at.bbox_inside_w[..., None],
                           at.bbox_outside_w[..., None], sigma=3.0)
        rpn_loss_box = torch.sum(rpn_l1) / e

        # ---- ROI heads ----
        spatial_fc7 = self._roi_features(gated, pt.rois, generator)
        r = spatial_fc7.shape[1]
        cls_score, bbox_pred = self.box_head(
            spatial_fc7.reshape(e * r, *spatial_fc7.shape[2:]))
        cls_score = cls_score.reshape(e, r, -1)
        bbox_pred = bbox_pred.reshape(e, r, m.num_classes, 4)
        ce = weighted_softmax_ce(cls_score, pt.labels, pt.roi_valid.float())
        # compact per-class bbox loss: the labelled class's deltas only
        lab = pt.labels.long()
        sel_pred = torch.gather(
            bbox_pred, 2, lab[..., None, None].expand(e, r, 1, 4))[:, :, 0]
        bw = pt.bbox_weight[..., None]
        loss_box = torch.sum(smooth_l1(sel_pred, pt.bbox_targets, bw, bw,
                                       sigma=1.0)) / (e * r)
        losses = {"rpn_cross_entropy": rpn_ce, "rpn_loss_box": rpn_loss_box,
                  "cross_entropy": ce, "loss_box": loss_box}

        # ---- mask loss on the fg slots (network.py:401-410) ----
        if m.use_mask_head:
            f = pt.mask_targets.shape[1]
            s = m.mask_size
            fg_fc7 = spatial_fc7[:, :f]
            fg_lab = torch.clamp(lab[:, :f], 0, m.num_classes - 1)
            sel = self.mask_head(fg_fc7.reshape(e * f, *fg_fc7.shape[2:]),
                                 labels=fg_lab.reshape(e * f))
            bce = bce_with_logits(sel.reshape(e, f, s, s), pt.mask_targets)
            mw = pt.mask_weight[:, :, None, None]
            bce = torch.where(mw > 0, bce, 0.0)
            denom = torch.clamp(torch.sum(pt.mask_weight), min=1.0) * s * s
            losses["loss_mask"] = torch.sum(bce * mw) / denom

        # ---- response loss (network_7f_response.py:411-428) ----
        if m.use_response_loss and m.use_language:
            stride = m.feat_stride
            tgt = response_target(gt_masks[:, 0], stride, h, w)
            ys = torch.arange(h, device=gated.device)[None, :, None] * stride
            xs = torch.arange(w, device=gated.device)[None, None, :] * stride
            vmask = ((ys < im_hw[:, 0, None, None])
                     & (xs < im_hw[:, 1, None, None])).float()
            bce = bce_with_logits(response[..., 0], tgt)
            losses["loss_response"] = (torch.sum(bce * vmask)
                                       / torch.clamp(torch.sum(vmask),
                                                     min=1.0))

        # ---- attribute loss (multi-label BCE on GT-box features) ----
        if m.use_attribute_head and "att_labels" in batch:
            # the un-gated map cropped at the GT box: attributes belong to
            # the referred object, not to the expression
            gt_fc7 = self._roi_features(net_conv, gt_boxes[:, :1, :4],
                                        generator)            # (E,1,S,S,D)
            att_logits = self.att_head(
                gt_fc7[:, 0].mean(dim=(1, 2)).float())       # (E, A)
            att_bce = bce_with_logits(att_logits,
                                      batch["att_labels"].float())
            av = batch.get("att_valid")
            av = (torch.ones((e,), device=att_logits.device) if av is None
                  else av.float())
            denom = torch.clamp(torch.sum(av), min=1.0) * att_logits.shape[1]
            losses["loss_att"] = m.att_loss_weight * \
                torch.sum(att_bce * av[:, None]) / denom

        # ---- caption (cycle-consistency) loss ----
        if m.use_caption_loss and m.use_language:
            losses["loss_caption"] = m.cap_loss_weight * self._caption_loss(
                net_conv, gated, batch, gt_masks, generator)

        losses["total_loss"] = sum(losses.values())
        return losses

    def gt_masked_map(self, net_conv: torch.Tensor, gt_masks: torch.Tensor
                      ) -> torch.Tensor:
        """net_conv (E, h, w, C) times each expression's GT mask (E, M, Hc,
        Wc), stride-centre sampled and thresholded at 0.5: the region
        features of the 'res5_2' pairing."""
        _, h, w, _ = net_conv.shape
        mk = response_target(gt_masks[:, 0], self.cfg.model.feat_stride, h, w)
        return net_conv * (mk >= 0.5).to(net_conv.dtype)[..., None]

    def caption_features(self, feats_a: torch.Tensor, feats_b: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The captioner's inputs from two (E, h, w, C) maps, each through
        the layer4 tail at full size: fc (E, 2 * 2048), the spatial means
        concatenated, and att (E, 196, 2 * 2048), each 14 x 14 adaptive
        pool concatenated; both f32."""
        fc5a = self.resnet.tail(feats_a)                      # (E, h, w, 2048)
        fc5b = self.resnet.tail(feats_b)
        fc = torch.cat([fc5a.mean(dim=(1, 2)), fc5b.mean(dim=(1, 2))], -1)
        att = torch.cat([_adaptive_pool(fc5a, 14),
                         _adaptive_pool(fc5b, 14)], -1)
        return fc.float(), att.reshape(att.shape[0], 196, -1).float()

    def _caption_loss(self, net_conv, gated, batch, gt_masks, generator):
        """Cycle consistency: the att2in2 captioner must reconstruct the
        expression from region features. `response_gate == 'sigmoid'`
        pairs the map before and after the gate (network_cycle_response.py:
        424-453), otherwise the whole map and its GT-masked copy
        (network_cycle_res5_2.py:415-448)."""
        if self.cfg.model.response_gate == "sigmoid":
            feats_b = gated
        else:
            feats_b = self.gt_masked_map(net_conv, gt_masks)
        fc, att = self.caption_features(net_conv, feats_b)
        return self.caption_model.teacher_forced_nll(
            fc, att, batch["cap_labels"], batch["cap_masks"], generator)

    # ---------- inference ----------

    @torch.no_grad()
    def test_forward(self, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
        """Single-image, batched-expression inference.

        batch: images (1, H, W, 3), im_hw (1, 2), labels (E, T), all on
        the model's device. Returns per-expression rois / scores / boxes
        and the gated conv map for the follow-up mask prediction
        (reference test_image, network.py:625-642). In test mode 'top'
        with fewer anchors than `rpn_top_n`, `generator` draws the
        proposals' random pad (default: a CPU generator seeded with
        cfg.seed, as the JAX package keys it without an image uid)."""
        cfg, m, ts = self.cfg, self.cfg.model, self.cfg.test
        if not m.use_language:
            raise NotImplementedError(
                "a no-language (`pretrain`) model cannot be served: the JAX "
                "package's Lang2Seg.test_forward conditions on expressions "
                "unconditionally (lang2seg_tpu/models/network.py:446), and "
                "the port keeps its behaviour")
        if ts.mode not in ("nms", "top"):
            raise ValueError(f"unknown test mode {ts.mode!r}")
        labels = batch["labels"]
        e = labels.shape[0]
        net_conv_img = self.backbone.head(self._images(batch["images"]))
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
        if ts.mode == "top":
            if generator is None and n < ts.rpn_top_n:
                generator = torch.Generator().manual_seed(cfg.seed)
            props = proposal_top_layer(score_pos, rpn_box.reshape(e, n, 4),
                                       anchors, hw[0], hw[1], ts.rpn_top_n,
                                       generator)
        else:
            props = proposal_layer(score_pos, rpn_box.reshape(e, n, 4),
                                   anchors, hw[0], hw[1],
                                   ts.rpn_pre_nms_top_n,
                                   ts.rpn_post_nms_top_n, ts.rpn_nms_thresh)
        spatial_fc7 = self._roi_features(gated, props.rois)
        r = spatial_fc7.shape[1]
        cls_score, bbox_pred = self.box_head(
            spatial_fc7.reshape(e * r, *spatial_fc7.shape[2:]))
        cls_score = cls_score.reshape(e, r, -1)
        cls_prob = torch.softmax(cls_score, dim=-1)
        bbox_pred = bbox_pred.reshape(e, r, m.num_classes, 4)
        # de-normalize deltas (network.py:607-613)
        stds = device_constant(cfg.train.bbox_normalize_stds, gated.device)
        means = device_constant(cfg.train.bbox_normalize_means, gated.device)
        bbox_pred = bbox_pred * stds + means
        return {"rois": props.rois, "roi_valid": props.valid,
                "cls_score": cls_score, "cls_prob": cls_prob,
                "bbox_pred": bbox_pred.reshape(e, r, -1),
                "gated_conv": gated, "response": response}

    @torch.no_grad()
    def predict_attribute_scores(self, images: torch.Tensor,
                                 boxes: torch.Tensor) -> torch.Tensor:
        """Sigmoid attribute scores of given boxes (reference
        eval_easy_utils.py:54-57 thresholds them at 0.5).

        images: (1, H, W, 3) uint8 BGR canvas or mean-subtracted f32;
        boxes: (1, B, 4) scaled coords. Returns (1, B, num_attributes) f32
        in [0, 1]."""
        if not self.cfg.model.use_attribute_head:
            raise ValueError("predict_attribute_scores: this model has no "
                             "attribute head (model.use_attribute_head)")
        net_conv = self.backbone.head(self._images(images))
        fc7 = self._roi_features(net_conv, boxes.float())
        return torch.sigmoid(self.att_head(fc7.mean(dim=(2, 3)).float()))

    @torch.no_grad()
    def predict_masks(self, gated_conv: torch.Tensor, boxes: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
        """Mask probs for given boxes and classes (reference
        _predict_masks_from_boxes_and_labels, network.py:550-581).

        gated_conv: (E, h, w, C); boxes: (E, B, 4) scaled coords; labels:
        (E, B) int class ids. Returns (E, B, S, S) in [0, 1]."""
        if not self.cfg.model.use_mask_head:
            raise ValueError("predict_masks: this model has no mask head "
                             "(a detection-only variant such as `vgg`)")
        s = self.cfg.model.mask_size
        fc7 = self._roi_features(gated_conv, boxes)
        e, b = fc7.shape[:2]
        sel = self.mask_head(fc7.reshape(e * b, *fc7.shape[2:]),
                             labels=labels.reshape(e * b))
        return torch.sigmoid(sel.reshape(e, b, s, s))


def _adaptive_pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """torch adaptive_avg_pool2d on NHWC (B, H, W, C) -> (B, out, out, C):
    bin i covers [floor(i * H / out), ceil((i + 1) * H / out)), as the JAX
    package's `_adaptive_pool` pools."""
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out)
    return y.permute(0, 2, 3, 1)


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
