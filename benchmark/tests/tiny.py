"""Small sizes of the cells for the CPU tests: the configuration files
cut to a 128 x 192 canvas, f32, a ResNet backbone to one block a stage
(any other backbone as the configuration names it) and small proposal
and ROI counts; the traffic files cut to a few expressions (a serving
cell to at most 4)."""

from __future__ import annotations

import copy
from typing import Dict

from benchmark import harness


def tiny_config(cfg_file: Dict) -> Dict:
    c = copy.deepcopy(cfg_file)
    t = c["config"]
    t["data"].update(canvas_h=128, canvas_w=192)
    if t["model"]["backbone"].startswith("resnet"):
        t["model"]["backbone"] = "resnet26"
    t["model"].update(vocab_size=100, cap_vocab_size=100,
                      compute_dtype="float32")
    t["train"].update(grad_clip_norm=10.0, learning_rate=1e-5,
                      rpn_pre_nms_top_n=512, rpn_post_nms_top_n=128,
                      roi_batch_size=32)
    t["test"].update(rpn_pre_nms_top_n=256, rpn_post_nms_top_n=32)
    return c


def tiny_traffic(traffic: Dict) -> Dict:
    t = copy.deepcopy(traffic)
    if t["entry"] == "train":
        t.update(expressions=4, ring=4)
    elif t["entry"] == "serve":
        t.update(expressions=min(t["expressions"], 4), ring=4,
                 check_requests=2, sure_per_s=0.5)
    else:
        t.update(real_counts=[3, 4, 2], buckets=[2, 4], check_dispatches=1,
                 sure_per_s=0.25, paste_buffers=[128, 192], im_scale=1.0)
    return t


def tiny_cell(cell_name: str, root=harness.ROOT):
    man = harness.manifest(root)
    cell = harness.cell(man, cell_name)
    return (tiny_config(harness.config_file(man, cell["config"], root)),
            tiny_traffic(harness.traffic_file(cell["traffic"], root)))
