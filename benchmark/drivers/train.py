"""Training: the program's `Trainer` at the configuration's
`steps_per_dispatch`, fed through its `FixedBatchLoader` over a ring of
distinct wire batches made from the seed, each step uploading its batch
as the Trainer does; no snapshots and no validation.

Set-up builds the one Trainer and takes its first steps through
`Trainer.train` (the window's own call and feed), on the ring's first
batches: the parameters before them, the momentum buffers after the
first (the gradient as the optimizer got it is the buffer less the
weight decay) and the parameters after the last are copied to the host,
and each step's losses and proposals kept. The window then runs
`Trainer.train` on chunks of steps until `--seconds` have passed, and
ends in a synchronisation.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from .. import check as chk
from .. import harness, traffic_gen
from ..flops import cached


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic

    def setup(self, program: bool = True) -> None:
        ctx = self.ctx
        self.ring = traffic_gen.train_ring(ctx.cfg_tree, self.t, ctx.seed)
        self.gen_seed = harness.generator_seed(ctx.seed)
        if not program:
            return
        from lang2seg_tpu_torch.data.synthetic import FixedBatchLoader
        from lang2seg_tpu_torch.engine import trainer as trainer_mod
        from lang2seg_tpu_torch.engine.trainer import Trainer
        from lang2seg_tpu_torch.models import network
        self.cfg = harness.program_config(ctx.cfg_tree, self.gen_seed)
        sd = ctx.weights()
        self.trainer = tr = Trainer(self.cfg, FixedBatchLoader(self.ring),
                                    output_dir=None, device=ctx.device,
                                    state_dict=sd)
        del sd
        self.checked = {"losses": [], "proposals": []}
        self._undo = []

        def patch(mod, attr, keep):
            orig = getattr(mod, attr)

            def wrapped(*args, **kwargs):
                out = orig(*args, **kwargs)
                keep(args, out)
                return out

            setattr(mod, attr, wrapped)
            self._undo.append(lambda: setattr(mod, attr, orig))

        patch(trainer_mod, "train_step",
              lambda a, out: self.checked["losses"].append(out))
        patch(network, "proposal_layer",
              lambda a, out: self.checked["proposals"].append((a, out)))
        opt = tr.state.optimizer
        names = {id(p): n for g in opt.param_groups
                 for n, p in zip(g["names"], g["params"])}
        decay = {id(p): g["weight_decay"] for g in opt.param_groups
                 for p in g["params"]}
        params = [p for g in opt.param_groups for p in g["params"]]
        p0 = {names[id(p)]: p.detach().to("cpu", copy=True) for p in params}
        tr.train(max_iters=1)
        grads = {}
        for p in params:
            buf = opt.state[p].get("momentum_buffer")
            n = names[id(p)]
            grads[n] = (torch.zeros_like(p0[n]) if buf is None else
                        buf.detach().to("cpu", copy=True) - decay[id(p)] * p0[n])
        steps = self.t["checked_steps"]
        tr.train(max_iters=steps)
        delta = {names[id(p)]: p.detach().to("cpu", copy=True) - p0[names[id(p)]]
                 for p in params}
        while self._undo:
            self._undo.pop()()
        self.mine = {"losses": [{k: float(v) for k, v in lo.items()}
                                for lo in self.checked["losses"]],
                     "grads": grads, "delta": delta}
        ctx.sync()

    def window(self, seconds: float) -> None:
        tr, chunk = self.trainer, self.t["chunk_steps"]
        first = tr.state.step
        self.ctx.sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            tr.train(max_iters=tr.state.step + chunk)
        self.ctx.sync()
        self.window_s = time.perf_counter() - t0
        self.steps = tr.state.step - first

    def end_to_end(self) -> Dict[str, float]:
        return {"train_expr_per_s":
                self.steps * self.t["expressions"] / self.window_s}

    def attempted(self):
        return self.steps, 0

    def flops_in_window(self) -> int:
        """Model FLOPs of the steps completed in the window."""
        return self.steps * cached(self.ctx.ref, "train", self.ctx.cfg_tree,
                                   self.t["images"], self.t["expressions"])

    def release(self) -> None:
        del self.trainer
        self.ctx.free()

    def _batches(self, n: int) -> List[Dict[str, torch.Tensor]]:
        return [{k: torch.from_numpy(v).to(self.ctx.device)
                 for k, v in self.ring[i % len(self.ring)].items()}
                for i in range(n)]

    def _prop_diff(self, rpn: List) -> int:
        t = self.ctx.cfg_tree["train"]
        return sum(chk.proposals_diff(
            self.ctx.ref, r["score_pos"], r["deltas"], r["anchors"],
            r["im_h"], r["im_w"], r["rois"], r["valid"],
            t["rpn_pre_nms_top_n"], t["rpn_post_nms_top_n"],
            t["rpn_nms_thresh"]) for r in rpn)

    def judged(self) -> Dict:
        rpn = [{"score_pos": a[0], "deltas": a[1], "anchors": a[2],
                "im_h": a[3], "im_w": a[4], "rois": out.rois,
                "valid": out.valid}
               for a, out in self.checked["proposals"]]
        return dict(self.mine, rpn=rpn)

    def check(self, judged=None) -> Dict[str, float]:
        ctx = self.ctx
        mine = self.judged() if judged is None else judged
        n = self.t["checked_steps"]
        e = self.t["expressions"]
        if len(mine["losses"]) != n or len(mine["rpn"]) != n or any(
                r["rois"].shape[0] != e for r in mine["rpn"]):
            return {}
        mine = dict(mine, prop_diff=self._prop_diff(mine["rpn"]))
        net = chk.reference_net(ctx.ref, ctx.cfg_tree, ctx.weights(),
                                ctx.device)
        theirs = chk.reference_steps(
            ctx.ref, net, ctx.cfg_tree, self._batches(n), self.gen_seed,
            [(r["rois"], r["valid"]) for r in mine["rpn"]])
        return chk.train_numbers(mine, theirs)

    def control(self) -> Dict:
        """The control's three steps: the reference in fp8 in the
        program's place, with its own proposals."""
        ctx = self.ctx
        net = chk.reference_net(ctx.ref, ctx.cfg_tree, ctx.weights(),
                                ctx.device, "fp8")
        out = chk.reference_steps(ctx.ref, net, ctx.cfg_tree,
                                  self._batches(self.t["checked_steps"]),
                                  self.gen_seed, None, record_rpn=True)
        return {"losses": out["losses"], "grads": out["grads"],
                "delta": out["delta"], "rpn": out["rpn"]}
