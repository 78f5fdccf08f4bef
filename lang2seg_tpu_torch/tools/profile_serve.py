"""Where a serving request's time goes on the card.

    python -m lang2seg_tpu_torch.tools.profile_serve [--expressions 16]

Builds the flagship `response` model at full width (random weights from
a seed), serves a warm-up request, then times one request stage by stage
with CUDA events (each stage is the model's own code, in the order of
`Lang2Seg.test_forward` and `Evaluator.eval_image`), and prints the ten
largest device-time entries of `torch.profiler` over one more request.
Prints one JSON line with the stage times. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..config import flagship_config
from ..data.synthetic import synthetic_eval_request
from ..engine.evaluator import Evaluator
from ..models.network import build_model
from ..ops.anchors import shifted_anchors
from ..ops.proposals import proposal_layer
from ..ops.roi_align import roi_crop_pool
from ..utils.metrics import SegEvalAccumulator


class _Stages:
    def __init__(self):
        self.events = []

    def mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def ms(self):
        torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[name] = a.elapsed_time(b)
        return out


@torch.no_grad()
def staged_request(model, cfg, b, dev):
    """One request through the model's own stages, timed between them."""
    m, ts = cfg.model, cfg.test
    st = _Stages()
    st.mark("start")
    images = torch.from_numpy(b["images"]).to(dev)
    labels = torch.from_numpy(b["labels"]).to(dev)
    hw = torch.from_numpy(b["im_hw"]).to(dev)[0]
    st.mark("upload")
    conv = model.backbone.head(model._images(images)).contiguous()
    st.mark("backbone_head")
    e = labels.shape[0]
    gated, _ = model._condition(conv.expand(e, *conv.shape[1:]), labels)
    st.mark("encoder_and_gate")
    cls, box = model.rpn_head(gated)
    st.mark("rpn_head")
    _, h, w, a, _ = cls.shape
    n = h * w * a
    anchors = shifted_anchors(h, w, m.feat_stride, m.anchor_scales,
                              m.anchor_ratios, device=dev)
    scores = torch.softmax(cls.reshape(e, n, 2), -1)[..., 1]
    props = proposal_layer(scores, box.reshape(e, n, 4), anchors, hw[0],
                           hw[1], ts.rpn_pre_nms_top_n,
                           ts.rpn_post_nms_top_n, ts.rpn_nms_thresh)
    st.mark("proposals_with_nms")
    crops = roi_crop_pool(gated, props.rois, m.pooling_size,
                          1.0 / m.feat_stride, m.max_pool)
    st.mark("roi_crop")
    r = crops.shape[1]
    fc7 = model.backbone.tail(crops.reshape(e * r, *crops.shape[2:]))
    st.mark("layer4_tail")
    model.box_head(fc7)
    st.mark("box_head")
    return st.ms()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--expressions", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cfg = flagship_config()
    model = build_model(cfg, device="cuda", seed=args.seed)
    ev = Evaluator(model, cfg)
    b = synthetic_eval_request(cfg, args.expressions, seed=1, im_scale=1.6)
    for _ in range(2):
        ev.eval_image(b, SegEvalAccumulator())
        staged_request(model, cfg, b, dev)
    stages = staged_request(model, cfg, b, dev)
    total = sum(stages.values())
    for k, v in stages.items():
        print(f"[stage] {k:20s} {v:9.3f} ms  {100 * v / total:5.1f}%")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev.eval_image(b, SegEvalAccumulator())
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=12)
    print(table)
    print(json.dumps({"device": smi, "expressions": args.expressions,
                      "stages_ms": stages}))


if __name__ == "__main__":
    main()
