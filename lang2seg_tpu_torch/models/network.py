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
tree (MobileNetV1's `mobilenet.*` keys have no reference names; see
`models/mobilenet.py`).

Ported: the ResNet backbones, VGG16 (the detection-only `vgg` variant:
C4 512, a 4096-wide fc6/fc7 tail, no mask head) and MobileNetV1 (C4 512,
a 1024-wide tail), the language path, `num_filters` 1 or 7, both gates,
test modes 'nms' and 'top', pooling modes 'crop' and 'pool' (ROI max
pooling, `ops/roi_align.py::roi_max_pool`, on every path that crops
ROIs), the detection, mask and response losses, the
caption-consistency loss of the `cycle` and `cycle_response` variants
(the att2in2 captioner, `caption_model.*`), and the no-language plain
Mask R-CNN of the `pretrain` variant (no `rnn_encoder` / `dynamic_fc*` /
`response_fc`; the backbone map goes straight to the RPN, each example
an image with up to M GT boxes and masks), which trains but, as in the
JAX package, cannot be served, and the attribute head (`att_head`: a
multi-label BCE on the un-gated map cropped at each expression's GT box,
`predict_attribute_scores`). A batch with `expr_uid` draws its anchor
and ROI subsamples per example (`ops/targets.py::example_uniforms`), as
the JAX package folds the uid into its sampling key.

At inference on the card the ResNet head (`models/resnet.py`) and the
language half of the conditioning (`_filters`: labels to the dynamic
filters) replay as CUDA graphs, one an input shape.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..device import GraphedPasses, device_constant, resolve_device
from ..ops.anchors import shifted_anchors
from ..ops.proposals import proposal_layer, proposal_top_layer
from ..ops.roi_align import roi_crop_pool, roi_max_pool
from ..ops.targets import (anchor_targets, example_uniforms,
                           proposal_targets, step_key)
from ..utils.trace import span
from .caption_zoo import setup_captioner
from .dynamic_filter import DynamicFilterGen
from .heads import BoxHead, MaskHead, RPNHead
from .lang_encoder import RNNEncoder
from .mobilenet import TAIL_DIM as MOBILENET_TAIL_DIM
from .mobilenet import MobileNetV1
from .resnet import ResNetC4
from .vgg import VGG16


# crops one call of the ROI tail takes at most outside training; past it
# the tail runs on pieces of TAIL_PIECE crops into one output. Test mode
# 'top' at 16 expressions crops 80,000 ROIs, and layer4's temporaries
# (each 2048-channel 7 x 7 map 16 GB in bf16) would need more than an
# 80 GB card; every other path (the evaluator's 4 x 32 chunk crops 38,400)
# takes one call
TAIL_CROPS = 40960
TAIL_PIECE = 8192

# the most label shapes (E, T) a Lang2Seg keeps a captured language half
# for; past it, calls run eager. Eight hold serving's E = 16, eval's
# dispatches of 1, 2 or 4 images of buckets 4 / 8 / 16 (E = 4, 8, 16, 32,
# 64) and a validation's E = 1
CONDITION_GRAPH_KEYS = 8

# a Lang2Seg -> the `GraphedPasses` of its language half (kept off the
# module: a deep copy or a pickle of the model carries no graph)
_LANGUAGE_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _in_pieces(fn, x: torch.Tensor, piece: int) -> torch.Tensor:
    """fn(x) for a function of each row of x alone, on `piece` rows a call,
    written into one output."""
    first = fn(x[:piece])
    out = first.new_empty((x.shape[0], *first.shape[1:]))
    out[:piece] = first
    for i in range(piece, x.shape[0], piece):
        out[i:i + piece] = fn(x[i:i + piece])
    return out


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
        if not (m.backbone.startswith("resnet")
                or m.backbone in ("vgg16", "mobilenet_v1")):
            raise ValueError(f"unknown backbone {m.backbone!r}")
        if m.pooling_mode not in ("crop", "pool"):
            raise ValueError(f"unknown pooling mode {m.pooling_mode!r}")
        self.compute_dtype = (torch.bfloat16 if m.compute_dtype == "bfloat16"
                              else torch.float32)
        # the reference names the backbone `vgg` or `resnet`, MobileNetV1
        # `mobilenet`; `backbone` reaches any of them
        if m.backbone == "vgg16":
            self.vgg = VGG16(self.compute_dtype)
            self.vgg.freeze()
            tail_dim = 4096
        elif m.backbone == "mobilenet_v1":
            # every conv trains, as in the JAX package; the BatchNorms are
            # buffers
            self.mobilenet = MobileNetV1(self.compute_dtype)
            tail_dim = MOBILENET_TAIL_DIM
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
        """The `ResNetC4`, `VGG16` or `MobileNetV1` (`head`, `tail`)."""
        b = self.cfg.model.backbone
        if b == "vgg16":
            return self.vgg
        return self.mobilenet if b == "mobilenet_v1" else self.resnet

    # ---------- building blocks ----------

    @span("l2s.condition")
    def _condition(self, net_conv: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   exprs_per_map: int = 1):
        """Language encoding + dynamic-filter gating.
        net_conv: (E // G, h, w, C), read by G = exprs_per_map consecutive
        expressions each; labels: (E, T); `generator` draws the
        word-dropout mask in train mode."""
        filt, rfilt = self._filters(labels, generator)
        return self.filter_gen.gate_map(net_conv, filt, rfilt,
                                        exprs_per_map)

    def _filters(self, labels: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The language half of `_condition`: labels (E, T) -> the filters
        (E, C, K) and the response filters (E, K), f32. With the labels on
        the card, no gradient recorded, the encoder in eval mode and no
        capture under way, a CUDA graph's replay, one a label shape
        (`device.GraphedPasses`: the eager pass's bits, fresh tensors,
        in-place weight updates seen, `condition.graph_*` counted); the
        eager pass otherwise (training, the CPU, a call inside another
        capture). The gate stays outside: its output is the largest
        tensor of the request."""
        if labels.is_cuda and not torch.is_grad_enabled() and \
                not self.rnn_encoder.training and \
                not torch.cuda.is_current_stream_capturing():
            g = _LANGUAGE_GRAPHS.get(self)
            if g is None:
                g = _LANGUAGE_GRAPHS[self] = GraphedPasses(
                    [self.rnn_encoder, *self.filter_gen.children()],
                    "condition")
            return g.run(self._language, (labels,), g.addresses(),
                         CONDITION_GRAPH_KEYS)
        return self._language(labels, generator)

    def _language(self, labels: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eager pass of `_filters`."""
        _, hidden, _ = self.rnn_encoder(labels, generator)
        return self.filter_gen.filters(hidden)

    @span("l2s.roi_tail")
    def _roi_features(self, gated: torch.Tensor, rois: torch.Tensor,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """gated: (E, h, w, C); rois: (E, R, 4) in scaled-image coords.
        Crops by bilinear sampling ('crop') or ROI max pooling ('pool').
        Returns spatial_fc7 (E, R, 7, 7, 2048) (ResNet), (E, R, 7, 7,
        1024) (MobileNetV1) or (E, R, 1, 1, 4096) (VGG16, whose tail draws
        its dropout masks from `generator` in train mode)."""
        m = self.cfg.model
        if m.pooling_mode == "pool":
            crops = roi_max_pool(gated, rois, m.pooling_size,
                                 1.0 / m.feat_stride)
        else:
            crops = roi_crop_pool(gated, rois, m.pooling_size,
                                  1.0 / m.feat_stride, m.max_pool)
        e, r = crops.shape[:2]
        flat = crops.reshape(e * r, *crops.shape[2:])
        if m.backbone == "vgg16":
            def tail(x):
                return self.vgg.tail(x, generator)
        else:
            tail = self.backbone.tail
        if torch.is_grad_enabled() or flat.shape[0] <= TAIL_CROPS:
            fc7 = tail(flat)
        else:
            fc7 = _in_pieces(tail, flat, TAIL_PIECE)
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
                      generator: Optional[torch.Generator] = None,
                      sampling_generator: Optional[torch.Generator] = None
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
        expr_uid (E,) int, optional: stable example ids. With them the
        anchor and ROI priorities are `ops/targets.py::example_uniforms`
        of the example's uid under one per-step key, drawn (in the anchor
        priorities' place) from `sampling_generator`, or from `generator`
        when that is None: an example draws the same subsample at any
        position, block or rank, as JAX folds the uid into its key.
        Returns the loss dict with `total_loss`, all scalars on the
        device."""
        m, t = self.cfg.model, self.cfg.train
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

        with span("l2s.backbone"):
            net_conv_img = self.backbone.head(images)         # (I, h, w, C)
        net_conv = net_conv_img.index_select(0, img_idx).contiguous()
        if m.use_language:
            gated, response = self._condition(net_conv, batch["labels"],
                                              generator)
        else:
            gated, response = net_conv, None
        at, pt = targets if targets is not None else (None, None)
        with span("l2s.rpn"):
            rpn_cls, rpn_box = self.rpn_head(gated)           # (E,h,w,A,2|4)
            _, h, w, a, _ = rpn_cls.shape
            anchors = shifted_anchors(h, w, m.feat_stride, m.anchor_scales,
                                      m.anchor_ratios, device=gated.device)
            n = anchors.shape[0]
            if pt is None:
                with torch.no_grad():
                    score_pos = torch.softmax(rpn_cls.reshape(e, n, 2),
                                              dim=-1)[..., 1]
        im_hw = batch["im_hw"].float().index_select(0, img_idx)   # (E, 2)

        key = uid = None
        if "expr_uid" in batch and (at is None or pt is None):
            key = step_key(sampling_generator if sampling_generator
                           is not None else generator)
            uid = batch["expr_uid"]
        with span("l2s.targets"):
            if at is None:
                at = anchor_targets(
                    anchors, gt_boxes, gt_valid, im_hw[:, 0], im_hw[:, 1],
                    draws=None if key is None else [
                        example_uniforms(key, uid, s, n) for s in (0, 1)],
                    generator=generator, rpn_batchsize=t.rpn_batchsize,
                    fg_fraction=t.rpn_fg_fraction,
                    pos_overlap=t.rpn_positive_overlap,
                    neg_overlap=t.rpn_negative_overlap,
                    clobber_positives=t.rpn_clobber_positives)
            if pt is None:
                with span("l2s.proposals"), torch.no_grad():
                    props = proposal_layer(
                        score_pos, rpn_box.reshape(e, n, 4), anchors,
                        im_hw[:, 0], im_hw[:, 1], t.rpn_pre_nms_top_n,
                        t.rpn_post_nms_top_n, t.rpn_nms_thresh)
                cand = props.rois.shape[1] + gt_boxes.shape[1]
                pt = proposal_targets(
                    props.rois, props.valid, gt_boxes, gt_valid,
                    gt_masks.to(torch.uint8), draws=None if key is None else [
                        example_uniforms(key, uid, 2, cand),
                        example_uniforms(key, uid, 3, cand),
                        example_uniforms(key, uid, 4, t.roi_batch_size)],
                    generator=generator,
                    num_rois=t.roi_batch_size, fg_fraction=t.fg_fraction,
                    fg_thresh=t.fg_thresh, bg_thresh_hi=t.bg_thresh_hi,
                    bg_thresh_lo=t.bg_thresh_lo, mask_size=m.mask_size,
                    normalize_means=t.bbox_normalize_means,
                    normalize_stds=t.bbox_normalize_stds, use_gt=t.use_gt)

        # ---- RPN losses (network.py:372-387) ----
        with span("l2s.losses"):
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
        with span("l2s.heads"):
            cls_score, bbox_pred = self.box_head(
                spatial_fc7.reshape(e * r, *spatial_fc7.shape[2:]))
            cls_score = cls_score.reshape(e, r, -1)
            bbox_pred = bbox_pred.reshape(e, r, m.num_classes, 4)
        with span("l2s.losses"):
            ce = weighted_softmax_ce(cls_score, pt.labels,
                                     pt.roi_valid.float())
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
            with span("l2s.mask"):
                sel = self.mask_head(fg_fc7.reshape(e * f, *fg_fc7.shape[2:]),
                                     labels=fg_lab.reshape(e * f))
            with span("l2s.losses"):
                bce = bce_with_logits(sel.reshape(e, f, s, s),
                                      pt.mask_targets)
                mw = pt.mask_weight[:, :, None, None]
                bce = torch.where(mw > 0, bce, 0.0)
                denom = torch.clamp(torch.sum(pt.mask_weight),
                                    min=1.0) * s * s
                losses["loss_mask"] = torch.sum(bce * mw) / denom

        # ---- response loss (network_7f_response.py:411-428) ----
        if m.use_response_loss and m.use_language:
            stride = m.feat_stride
            with span("l2s.losses"):
                tgt = response_target(gt_masks[:, 0], stride, h, w)
                ys = torch.arange(h, device=gated.device)[None, :, None] \
                    * stride
                xs = torch.arange(w, device=gated.device)[None, None, :] \
                    * stride
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
        the backbone's tail at full size (layer4, or MobileNetV1's two
        1024-wide blocks): fc (E, 2 * D), the spatial means concatenated,
        and att (E, 196, 2 * D), each 14 x 14 adaptive pool concatenated;
        both f32."""
        fc5a = self.backbone.tail(feats_a)                    # (E, h, w, D)
        fc5b = self.backbone.tail(feats_b)
        fc = torch.cat([fc5a.mean(dim=(1, 2)), fc5b.mean(dim=(1, 2))], -1)
        att = torch.cat([_adaptive_pool(fc5a, 14),
                         _adaptive_pool(fc5b, 14)], -1)
        return fc.float(), att.reshape(att.shape[0], 196, -1).float()

    @span("l2s.caption")
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
        m = self.cfg.model
        if (fc.shape[-1], att.shape[-1]) != (m.cap_fc_feat_size,
                                             m.cap_att_feat_size):
            raise ValueError(
                f"the captioner is sized by model.cap_fc_feat_size / "
                f"cap_att_feat_size ({m.cap_fc_feat_size}, "
                f"{m.cap_att_feat_size}), but {m.backbone}'s caption "
                f"features are {fc.shape[-1]} wide (twice its tail's "
                f"width): set both to {fc.shape[-1]}")
        return self.caption_model.teacher_forced_nll(
            fc, att, batch["cap_labels"], batch["cap_masks"], generator)

    # ---------- inference ----------

    @torch.no_grad()
    def test_forward(self, batch: Dict[str, torch.Tensor],
                     generator=None) -> Dict[str, torch.Tensor]:
        """Batched-expression inference over N images of S expressions
        each.

        batch: images (N, H, W, 3), im_hw (N, 2), labels (N * S, T)
        image-major, all on the model's device. The backbone runs once an
        image and each expression's gate reads its image's map in place.
        Returns per-expression rois / scores / boxes and the gated conv
        map for the follow-up mask prediction (reference test_image,
        network.py:625-642), as N single-image calls would, expressions
        image-major. In test mode 'top' with fewer anchors than
        `rpn_top_n`, each image draws its proposals' random pad from its
        own generator: `generator` is one (N = 1) or a sequence of N, in
        image order (default: CPU generators seeded with cfg.seed, as the
        JAX package keys them without an image uid). The JAX package gets
        the N-image form from `jax.vmap` over one image
        (`lang2seg_tpu/engine/evaluator.py::_batched_eval_fn`)."""
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
        with span("l2s.backbone"):
            net_conv_img = self.backbone.head(self._images(batch["images"]))
        num_images = net_conv_img.shape[0]
        if e % num_images:
            raise ValueError(f"test_forward: {e} expressions for "
                             f"{num_images} images")
        per_image = e // num_images
        gated, response = self._condition(net_conv_img.contiguous(), labels,
                                          exprs_per_map=per_image)
        with span("l2s.rpn"):
            rpn_cls, rpn_box = self.rpn_head(gated)
            _, h, w, a, _ = rpn_cls.shape
            anchors = shifted_anchors(h, w, m.feat_stride, m.anchor_scales,
                                      m.anchor_ratios, device=gated.device)
            n = anchors.shape[0]
            score_pos = torch.softmax(rpn_cls.reshape(e, n, 2),
                                      dim=-1)[..., 1]
        hw = batch["im_hw"].float()[:, None, :].expand(
            num_images, per_image, 2).reshape(e, 2)         # per expression
        with span("l2s.proposals"):
            props = self._proposals(score_pos, rpn_box.reshape(e, n, 4),
                                    anchors, hw, per_image, generator)
        spatial_fc7 = self._roi_features(gated, props.rois)
        r = spatial_fc7.shape[1]
        with span("l2s.heads"):
            cls_score, bbox_pred = self.box_head(
                spatial_fc7.reshape(e * r, *spatial_fc7.shape[2:]))
            cls_score = cls_score.reshape(e, r, -1)
            cls_prob = torch.softmax(cls_score, dim=-1)
            bbox_pred = bbox_pred.reshape(e, r, m.num_classes, 4)
            # de-normalize deltas (network.py:607-613)
            stds = device_constant(cfg.train.bbox_normalize_stds,
                                   gated.device)
            means = device_constant(cfg.train.bbox_normalize_means,
                                    gated.device)
            bbox_pred = bbox_pred * stds + means
        return {"rois": props.rois, "roi_valid": props.valid,
                "cls_score": cls_score, "cls_prob": cls_prob,
                "bbox_pred": bbox_pred.reshape(e, r, -1),
                "gated_conv": gated, "response": response}

    def _proposals(self, score_pos, deltas, anchors, hw, per_image,
                   generator):
        """`test_forward`'s proposals for (E, N) scores and (E, N, 4)
        deltas: NMS (test mode 'nms') or the top anchors ('top')."""
        cfg, ts = self.cfg, self.cfg.test
        e, n = score_pos.shape
        num_images = e // per_image
        if ts.mode == "top":
            order = None
            if n < ts.rpn_top_n:
                gens = (list(generator) if isinstance(generator,
                                                      (list, tuple))
                        else [generator])
                if len(gens) != num_images:
                    raise ValueError(f"test_forward: {len(gens)} generators "
                                     f"for {num_images} images")
                gens = [torch.Generator().manual_seed(cfg.seed) if g is None
                        else g for g in gens]
                order = torch.cat([
                    torch.randint(0, n, (per_image, ts.rpn_top_n),
                                  generator=g, device=g.device)
                    for g in gens])
            return proposal_top_layer(score_pos, deltas, anchors, hw[:, 0],
                                      hw[:, 1], ts.rpn_top_n, order=order)
        return proposal_layer(score_pos, deltas, anchors, hw[:, 0], hw[:, 1],
                              ts.rpn_pre_nms_top_n, ts.rpn_post_nms_top_n,
                              ts.rpn_nms_thresh)

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
    @span("l2s.mask")
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
