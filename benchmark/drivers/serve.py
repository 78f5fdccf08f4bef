"""Serving, closed loop, one client: `Evaluator.eval_image` on its
device-paste path, one request after another over a ring of distinct
requests made from the seed in set-up.

A request runs from the host arrays handed to `eval_image` to its
return, after its boxes and I / U counts are read back. The latency of
every request completed in the window counts. For the check, the
requests at indices drawn from the seed keep what `test_forward`, the
proposal layer and the mask head returned on the way (references to the
program's own device tensors) beside the answers the accumulator got.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import check as chk
from .. import harness, traffic_gen
from ..flops import cached


class Recorder:
    """The accumulator `eval_image` reports to: each valid sentence's
    selected box and I / U counts, by request."""

    def __init__(self):
        self.current = None
        self.answers: Dict[int, Dict[str, List]] = {}

    def start(self, i: int) -> "Recorder":
        self.current = self.answers.setdefault(
            i, {"sel": [], "inter": [], "union": []})
        return self

    def add_detection(self, pred_box, gt_box) -> None:
        self.current["sel"].append(np.asarray(pred_box, np.float32))

    def add_segmentation_iu(self, i, u) -> None:
        self.current["inter"].append(float(i))
        self.current["union"].append(float(u))


class Capture:
    """References to what the timed path computed on the way, for the
    requests being captured."""

    def __init__(self):
        self.on = False
        self.current: Dict = {}
        self.records: Dict[int, Dict] = {}
        self._undo = []

    def start(self, i):
        self.on = i is not None
        if self.on:
            self.current = self.records.setdefault(i, {})

    def patch(self, obj, attr, keep):
        orig = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            if self.on:
                keep(self.current, args, out)
            return out

        setattr(obj, attr, wrapped)
        self._undo.append(lambda: setattr(obj, attr, orig))

    def undo(self):
        while self._undo:
            self._undo.pop()()


def _keep_forward(rec, args, out):
    for k in ("rois", "roi_valid", "cls_score", "bbox_pred", "response",
              "gated_conv"):
        rec[k] = out[k]


def _keep_head(rec, args, out):
    rec["net_conv"] = out


def _keep_proposals(rec, args, out):
    rec["score_pos"], rec["deltas"] = args[0], args[1]


def _keep_masks(rec, args, out):
    rec["probs"] = out


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic

    def setup(self, program: bool = True) -> None:
        ctx = self.ctx
        self.ring = traffic_gen.serve_ring(ctx.cfg_tree, self.t, ctx.seed)
        rng = np.random.RandomState(traffic_gen.sub_seed(ctx.seed, 9))
        horizon = max(self.t["check_requests"],
                      int(ctx.seconds * self.t["sure_per_s"]))
        self.sample = sorted(int(i) for i in rng.choice(
            horizon, self.t["check_requests"], replace=False))
        if not program:
            return
        from lang2seg_tpu_torch.engine.evaluator import Evaluator
        from lang2seg_tpu_torch.models import network
        from lang2seg_tpu_torch.models.network import build_model
        self.cfg = harness.program_config(ctx.cfg_tree,
                                          harness.generator_seed(ctx.seed))
        sd = ctx.weights()
        self.model = build_model(self.cfg, device=ctx.device, state_dict=sd)
        del sd
        self.ev = Evaluator(self.model, self.cfg, device=ctx.device)
        self.capture = cap = Capture()
        cap.patch(self.model, "test_forward", _keep_forward)
        cap.patch(self.model, "predict_masks", _keep_masks)
        cap.patch(self.model.backbone, "head", _keep_head)
        cap.patch(network, "proposal_layer", _keep_proposals)
        warm = Recorder()
        for i in range(self.t["warm_requests"]):
            self.ev.eval_image(self.ring[i % len(self.ring)], warm.start(i))
        ctx.sync()

    def window(self, seconds: float) -> None:
        ring, ev = self.ring, self.ev
        rec, cap = Recorder(), self.capture
        wanted = set(self.sample)
        lat: List[float] = []
        t0 = time.perf_counter()
        i = 0
        while True:
            cap.start(i if i in wanted else None)
            ts = time.perf_counter()
            ev.eval_image(ring[i % len(ring)], rec.start(i))
            lat.append(time.perf_counter() - ts)
            i += 1
            if ts + lat[-1] - t0 >= seconds:
                break
        cap.start(None)
        self.window_s = time.perf_counter() - t0
        self.lat, self.rec, self.done = lat, rec, i

    def end_to_end(self) -> Dict[str, float]:
        ms = [x * 1e3 for x in self.lat]
        return {"request_ms_p50": harness.quantile(ms, 0.5),
                "request_ms_p95": harness.quantile(ms, 0.95)}

    def attempted(self):
        return self.done, 0

    def flops_in_window(self) -> int:
        """Model FLOPs of the requests completed in the window."""
        return self.done * cached(self.ctx.ref, "serve", self.ctx.cfg_tree,
                                  1, self.t["expressions"])

    def release(self) -> None:
        self.capture.undo()
        del self.ev, self.model
        self.ctx.free()

    def judged(self) -> List:
        """(requests, record) of each sampled request the window served."""
        out = []
        for i in self.sample:
            rec = self.capture.records.get(i)
            ans = self.rec.answers.get(i)
            if rec is None or ans is None:
                out.append(None)
                continue
            rec = dict(rec, sel=np.stack(ans["sel"]), inter=ans["inter"],
                       union=ans["union"])
            out.append(([self.ring[i % len(self.ring)]], rec))
        return out

    def check(self, judged=None) -> Dict[str, float]:
        ctx = self.ctx
        judged = self.judged() if judged is None else judged
        net = chk.reference_net(ctx.ref, ctx.cfg_tree, ctx.weights(),
                                ctx.device)
        worst: Dict[str, float] = {}
        for item in judged:
            if item is None:
                return {}
            reqs, rec = item
            for k, v in chk.serve_numbers(ctx.ref, net, ctx.cfg_tree, reqs,
                                          rec).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    def control(self) -> List:
        """The control's records of the sampled requests: the reference
        in fp8 in the program's place."""
        ctx = self.ctx
        net = chk.reference_net(ctx.ref, ctx.cfg_tree, ctx.weights(),
                                ctx.device, "fp8")
        return [([self.ring[i % len(self.ring)]],
                 chk.control_serve_record(ctx.ref, net, ctx.cfg_tree,
                                          [self.ring[i % len(self.ring)]],
                                          ctx.device))
                for i in self.sample]
