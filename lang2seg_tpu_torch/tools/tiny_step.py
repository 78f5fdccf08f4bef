"""One tiny f32 training step on the card and on the CPU, for holding the
card's kernels against their plain versions end to end.

    python -m lang2seg_tpu_torch.tools.tiny_step [--variant response]

The step runs at the tiny test config (resnet26, or VGG16 for `--variant
vgg`, 128x192 canvas, f32, normalized response, 2 images x 4
expressions; `--variant pretrain`: 2 images with 4 GT boxes and masks
each, no language; `--variant response_att`: `response` with the
attribute head and attribute labels; `--variant topdown`:
`cycle_response` with the topdown caption decoder; `--variant
mobilenet_pool`: `response` on MobileNetV1 (C4 512) with ROI max
pooling, so that the ROI pool kernel and its backward run) from the same
weights, the same dropout draws (a CPU generator feeds both devices: word dropout, VGG16's fc6 / fc7 dropout and
the captioner's) and the same injected anchor and ROI targets (the port's
samplers on jittered GT boxes), so that the two runs differ only by their
kernels and by f32 summation order. The LR is 1, so that each update stands far above the
parameters' own f32 rounding. `compare` gives the losses' relative error
and each updated tensor's relative L2 error, except for the tensors whose
exact gradient is zero (`ROUNDING_ONLY`), whose update norm it reports
instead. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import Config, apply_variant
from ..data.synthetic import (synthetic_batch, synthetic_detection_batch,
                              to_wire)
from ..engine.train_state import create_train_state, to_device, train_step
from ..ops.anchors import shifted_anchors
from ..ops.targets import anchor_targets, proposal_targets
from ..utils.trace import counters
from ..weights import init_params


# steps beyond the presets: (preset, model overrides)
VARIANTS = {"response_att": ("response", {"use_attribute_head": True,
                                          "num_attributes": 6}),
            "topdown": ("cycle_response", {"caption_model": "topdown"}),
            "mobilenet_pool": ("response", {"backbone": "mobilenet_v1",
                                            "c4_feat_dim": 512,
                                            "pooling_mode": "pool"})}
# backbones whose depth is fixed: the others get the resnet26 depth
FIXED_DEPTH = ("vgg16", "mobilenet_v1")


def tiny_config(variant: str = "response") -> Config:
    """The variant's preset at the tiny size; ResNet presets get the
    resnet26 depth, `vgg` keeps its VGG16 and `mobilenet_pool` its
    MobileNetV1 (whose depths are fixed). `response_att` is `response`
    with the attribute head (6 attributes), `topdown` is `cycle_response`
    with the topdown caption decoder, `mobilenet_pool` is `response` on
    MobileNetV1 with ROI max pooling."""
    preset, overrides = VARIANTS.get(variant, (variant, {}))
    cfg = apply_variant(Config(), preset)
    for k, v in overrides.items():
        setattr(cfg.model, k, v)
    cfg.data.canvas_h, cfg.data.canvas_w = 128, 192
    if cfg.model.backbone not in FIXED_DEPTH:
        cfg.model.backbone = "resnet26"
    cfg.model.vocab_size = 100
    cfg.model.compute_dtype = "float32"
    cfg.model.normalize_response = True
    cfg.model.cap_drop_prob_lm = 0.0
    cfg.train.grad_clip_norm = 10.0
    cfg.train.learning_rate = 1.0
    cfg.train.roi_batch_size = 32
    cfg.data.max_gt_per_image = 4
    return cfg


def tiny_inputs(cfg: Config, seed: int = 5, num_gt: int = 4):
    """(batch in the wire formats, (AnchorTargets, ProposalTargets)) on the
    CPU: 2 images x 4 expressions (with seeded attribute labels, the
    second expression invalid, when the model has the attribute head),
    or without language 2 images with `num_gt` of their
    cfg.data.max_gt_per_image GT slots filled; targets
    from the port's samplers on 64 rois an example jittered around its GT
    boxes (the same number around each)."""
    if cfg.model.use_language:
        batch = to_wire(cfg, synthetic_batch(cfg, 2, 4, seed=seed))
        gt = torch.from_numpy(batch["gt_boxes"])[:, None]
        valid = torch.ones(gt.shape[:2], dtype=torch.bool)
    else:
        batch = to_wire(cfg, synthetic_detection_batch(cfg, 2, num_gt,
                                                       seed=seed))
        gt = torch.from_numpy(batch["gt_boxes"])
        valid = torch.from_numpy(batch["gt_valid"])
    e = gt.shape[0]
    if cfg.model.use_attribute_head:
        r = np.random.RandomState(seed + 2)
        batch["att_labels"] = (r.rand(e, cfg.model.num_attributes)
                               < 0.4).astype(np.float32)
        batch["att_valid"] = np.arange(e) != 1
    g = torch.Generator().manual_seed(seed + 1)
    im_hw = torch.from_numpy(batch["im_hw"][batch["img_idx"]])
    anchors = shifted_anchors(cfg.data.canvas_h // 16, cfg.data.canvas_w // 16,
                              16, cfg.model.anchor_scales,
                              cfg.model.anchor_ratios)
    at = anchor_targets(anchors, gt, valid, im_hw[:, 0], im_hw[:, 1],
                        generator=g)
    # 64 rois an example, spread evenly over its valid GT boxes
    n_gt = int(valid[0].sum())
    src = gt[:, torch.arange(64) % n_gt, :4]
    rois = src + torch.randn((e, 64, 4), generator=g) * 6.0
    rois = torch.clamp(rois, min=0.0)
    rois[..., 2:] = torch.maximum(rois[..., 2:], rois[..., :2] + 4.0)
    masks = np.unpackbits(batch["gt_masks"], axis=-1)
    if masks.ndim == 3:
        masks = masks[:, None]
    pt = proposal_targets(rois, torch.ones((e, 64), dtype=torch.bool), gt,
                          valid, torch.from_numpy(masks), generator=g,
                          num_rois=cfg.train.roi_batch_size)
    return batch, (at, pt)


# the launch counters `step_on` reads (`utils/trace.py`)
LAUNCHES = ("nms.launches", "gate.launches", "gate.bwd_launches",
            "roi_pool.launches", "roi_pool.bwd_launches")


def step_on(cfg: Config, state_dict, batch, targets, device
            ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor],
                       Tuple[int, ...]]:
    """One train_step on `device`: (losses, per-tensor updates on the CPU,
    kernel launches (NMS, gate, gate backward, ROI pool, ROI pool
    backward) it made)."""
    state = create_train_state(cfg, device=device, state_dict=state_dict)
    old = {k: v.detach().float().cpu().clone()
           for k, v in state.model.state_dict().items()}
    c0 = counters()
    targets = tuple(type(t)(*(x.to(device) for x in t)) for t in targets)
    losses = train_step(state, to_device(batch, device),
                        torch.Generator().manual_seed(0), targets)
    losses = {k: float(v) for k, v in losses.items()}
    c1 = counters()
    launched = tuple(c1.get(n, 0) - c0.get(n, 0) for n in LAUNCHES)
    updates = {k: v.detach().float().cpu() - old[k]
               for k, v in state.model.state_dict().items()}
    return losses, updates, launched


# Tensors whose gradient is zero in exact arithmetic, so that their update
# is f32 rounding alone (~1e-12 at LR 1): the attention logits' bias, under
# a softmax that is invariant to a shift of its inputs.
ROUNDING_ONLY = ("caption_model.core.attention.alpha_net.bias",)


def compare(card, cpu) -> Dict[str, object]:
    """Errors of the card's step against the CPU's: each loss's relative
    error, the largest relative L2 error of an update (and its tensor),
    the tensors compared, any tensor that moved on the card only, and the
    largest L2 norm of a ROUNDING_ONLY tensor's update on either device
    (those are not held to a relative error)."""
    (lc, dc, _), (lp, dp, _) = card, cpu
    loss_err = {k: abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    upd_err = {k: float((dc[k] - dp[k]).norm() / dp[k].norm())
               for k in dp if float(dp[k].norm()) > 0
               and k not in ROUNDING_ONLY}
    worst = max(upd_err, key=upd_err.get)
    rounding = [float(d[k].norm()) for k in ROUNDING_ONLY if k in dp
                for d in (dc, dp)]
    return {"loss_rel_err": loss_err, "update_rel_err_max": upd_err[worst],
            "worst": worst, "tensors": len(upd_err),
            "moved_on_card_only": [k for k in dp if float(dp[k].norm()) == 0
                                   and float(dc[k].norm()) > 0],
            "rounding_only_max": max(rounding, default=0.0)}


def card_vs_cpu(variant: str = "response", seed: int = 7):
    """The tiny step of `variant` on the card and on the CPU from
    init_params(seed): (compare(...), the card's launches)."""
    cfg = tiny_config(variant)
    sd = init_params(cfg, seed)
    batch, targets = tiny_inputs(cfg)
    card = step_on(cfg, sd, batch, targets, "cuda")
    torch.cuda.synchronize()
    cpu = step_on(cfg, sd, batch, targets, "cpu")
    return compare(card, cpu), card[2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", default="response")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tiny_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs, launched = card_vs_cpu(args.variant)
    print(json.dumps(dict(errs, launches=launched)))


if __name__ == "__main__":
    main()
