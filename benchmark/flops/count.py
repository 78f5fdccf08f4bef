"""Model FLOPs of a cell's unit of work, counted from the cell's shapes
with the configuration's plain reference module (`ref`) on the meta
device (no data, no time), by `torch.utils.flop_counter.FlopCounterMode`:
every convolution and matrix product, forward and, for a training step,
backward (no recompute). The ROI crop is counted as the gather it is (no
product), so the count is the model's, not the count of whatever the
program launches.

* `serve`: one `test_forward` of N images x S expressions, the box
  selection, the mask head on each expression's box and the paste-back;
* `train`: one training step's forward and backward.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


def _meta_model(ref, cfg: Dict, train: bool):
    with torch.device("meta"):
        net = ref.Reference(copy.deepcopy(cfg))
    net.set_frozen()
    return net.train(train)


def serve_flops(ref, cfg: Dict, num_images: int, exprs_per_image: int
                ) -> int:
    net = _meta_model(ref, cfg, False)
    d = cfg["data"]
    e = num_images * exprs_per_image
    dev = "meta"
    images = torch.empty((num_images, d["canvas_h"], d["canvas_w"], 3),
                         dtype=torch.uint8, device=dev)
    labels = torch.empty((e, d["max_len"]), dtype=torch.int64, device=dev)
    im_hw = torch.empty((num_images, 2), device=dev)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net.crop = ref.crop_gather
        out = net.test_forward(images, im_hw, labels)
        scale = torch.empty((e,), device=dev)
        box, _, cls = ref.select_boxes(
            out["rois"], out["bbox_pred"], torch.softmax(out["cls_score"], -1),
            out["roi_valid"], scale, scale, scale)
        probs = net.mask_probs(out["gated"], box[:, None, :], cls[:, None])
        ext = torch.empty((e,), dtype=torch.int64, device=dev)
        ref.paste_iou(probs[:, 0], box, torch.empty(
            (e, d["canvas_h"], d["canvas_w"]), dtype=torch.uint8, device=dev),
            ext, ext, ext, ext, d["max_orig_h"], d["max_orig_w"])
    return int(fc.get_total_flops())


def train_flops(ref, cfg: Dict, num_images: int, num_expr: int) -> int:
    net = _meta_model(ref, cfg, True)
    d, m = cfg["data"], cfg["model"]
    dev = "meta"
    t = m["cap_seq_length"] + 2
    batch = {
        "images": torch.empty((num_images, d["canvas_h"], d["canvas_w"], 3),
                              dtype=torch.uint8, device=dev),
        "im_hw": torch.empty((num_images, 2), device=dev),
        "img_idx": torch.empty((num_expr,), dtype=torch.int64, device=dev),
        "labels": torch.empty((num_expr, d["max_len"]), dtype=torch.int64,
                              device=dev),
        "gt_boxes": torch.empty((num_expr, 5), device=dev),
        "gt_masks": torch.empty((num_expr, d["canvas_h"], d["canvas_w"] // 8),
                                dtype=torch.uint8, device=dev),
        "cap_labels": torch.empty((num_expr, t), dtype=torch.int64,
                                  device=dev),
        "cap_masks": torch.empty((num_expr, t), device=dev)}
    with FlopCounterMode(display=False) as fc:
        net.crop = ref.crop_gather
        losses = net.train_forward(batch, None)
        losses["total_loss"].backward()
    return int(fc.get_total_flops())
