"""Scoring a split: `Evaluator.eval_split` at the traffic's images a
dispatch, with its staged uploads, extent crop and pipeline depth, over
the mix's images made from the seed, cycled until `--seconds` have
passed. The window runs from the first dispatch to the return of the
last drain; every valid (unpadded) expression scored counts.

For the check, the dispatches at indices drawn from the seed keep what
`test_forward`, the proposal layer and the mask head returned inside
them, and the dispatch's own boxes and I / U counts (the values the
drain reads back).
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List

import numpy as np

from .. import check as chk
from .. import harness, traffic_gen
from ..flops import cached
from .serve import (Capture, _keep_forward, _keep_head, _keep_masks,
                    _keep_proposals)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        # the evaluator's paste buffers are the traffic's largest original
        # extent; both sides read them from the configuration
        ctx.cfg_tree = copy.deepcopy(ctx.cfg_tree)
        ctx.cfg_tree["data"]["max_orig_h"], \
            ctx.cfg_tree["data"]["max_orig_w"] = self.t["paste_buffers"]

    def setup(self, program: bool = True) -> None:
        ctx = self.ctx
        self.mix = traffic_gen.eval_mix(ctx.cfg_tree, self.t, ctx.seed)
        rng = np.random.RandomState(traffic_gen.sub_seed(ctx.seed, 9))
        horizon = max(self.t["check_dispatches"],
                      int(ctx.seconds * self.t["sure_per_s"]))
        self.sample = sorted(int(i) for i in rng.choice(
            horizon, self.t["check_dispatches"], replace=False))
        if not program:
            return
        from lang2seg_tpu_torch.engine.evaluator import Evaluator
        from lang2seg_tpu_torch.models import network
        from lang2seg_tpu_torch.models.network import build_model
        self.cfg = harness.program_config(ctx.cfg_tree,
                                          harness.generator_seed(ctx.seed))
        self.cfg.data.wire_extent_crop = bool(self.t["extent_crop"])
        sd = ctx.weights()
        self.model = build_model(self.cfg, device=ctx.device, state_dict=sd)
        del sd
        self.ev = ev = Evaluator(self.model, self.cfg, device=ctx.device)
        self.capture = cap = Capture()
        cap.patch(self.model, "test_forward", _keep_forward)
        cap.patch(self.model, "predict_masks", _keep_masks)
        cap.patch(self.model.backbone, "head", _keep_head)
        cap.patch(network, "proposal_layer", _keep_proposals)
        self.dispatches: List[tuple] = []
        self.wanted = set()
        orig = ev._dispatch_staged

        def dispatch(st):
            k = len(self.dispatches)
            self.dispatches.append((len(st["chunk"]), st["s"]))
            cap.start(k if k in self.wanted else None)
            out = orig(st)
            if cap.on:
                cap.current.update(chunk=st["chunk"], sel=out["sel"],
                                   inter=out["inter"], union=out["union"])
            cap.start(None)
            return out

        ev._dispatch_staged = dispatch
        # every dispatch shape the window can meet: each bucket at every
        # chunk size up to images_per_dispatch (a bucket's remainder goes
        # in power-of-two chunks when the window's images stop)
        by_bucket: Dict[int, List] = {}
        for b in self.mix:
            by_bucket.setdefault(b["labels"].shape[0], []).append(b)
        n = self.t["images_per_dispatch"]
        for group in by_bucket.values():
            k = 1
            while k <= n:
                self._split(images=[group[i % len(group)] for i in range(k)])
                k *= 2
        ctx.sync()
        self.dispatches.clear()

    def _split(self, images=None, seconds=None):
        """One `eval_split` over `images`, or over the mix cycled until
        `seconds` have passed; returns the valid expressions it scored."""
        t0 = time.perf_counter()
        count = {"valid": 0}

        def cycled():
            i = 0
            while time.perf_counter() - t0 < seconds:
                yield self.mix[i % len(self.mix)]
                i += 1

        def counted(source):
            for b in source:
                count["valid"] += int(np.sum(b["sent_valid"]))
                yield b

        self.ev.eval_split(counted(cycled() if images is None else images),
                           pipeline_depth=self.t["pipeline_depth"],
                           images_per_dispatch=self.t["images_per_dispatch"],
                           stage_uploads=bool(self.t["stage_uploads"]))
        return count["valid"]

    def window(self, seconds: float) -> None:
        self.wanted = set(self.sample)
        t0 = time.perf_counter()
        self.valid = self._split(seconds=seconds)
        self.ctx.sync()
        self.window_s = time.perf_counter() - t0
        self.wanted = set()

    def end_to_end(self) -> Dict[str, float]:
        return {"eval_expr_per_s": self.valid / self.window_s}

    def attempted(self):
        return len(self.dispatches), 0

    def flops_in_window(self) -> int:
        """Model FLOPs of the dispatches, padded slots included."""
        return sum(cached(self.ctx.ref, "serve", self.ctx.cfg_tree, n, s)
                   for n, s in self.dispatches)

    def release(self) -> None:
        self.capture.undo()
        del self.ev, self.model
        self.ctx.free()

    def judged(self) -> List:
        out = []
        for k in self.sample:
            rec = self.capture.records.get(k)
            if rec is None or "sel" not in rec:
                out.append(None)
                continue
            rec = dict(rec, sel=rec["sel"].cpu().numpy(),
                       inter=rec["inter"].cpu().numpy(),
                       union=rec["union"].cpu().numpy())
            out.append((rec.pop("chunk"), rec))
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
        """The control's records of dispatches of the sampled sizes: the
        reference in fp8 in the program's place, on chunks of the mix
        as the program groups them (images of one bucket)."""
        ctx = self.ctx
        net = chk.reference_net(ctx.ref, ctx.cfg_tree, ctx.weights(),
                                ctx.device, "fp8")
        groups: Dict[int, List] = {}
        for b in self.mix:
            groups.setdefault(b["labels"].shape[0], []).append(b)
        chunks = [g[:self.t["images_per_dispatch"]] for g in groups.values()]
        return [(c, chk.control_serve_record(ctx.ref, net, ctx.cfg_tree, c,
                                             ctx.device)) for c in chunks]
