"""Training driver.

Counterpart of `lang2seg_tpu/engine/trainer.py` (reference
SolverWrapper.train_model, `model/train_val.py:308-409`), on one device:
one SGD step per (I images x E expressions) batch of
`loader.get_batch("train")`, drawn ahead by a `Prefetcher` thread; the
losses printed every `display` steps with `speed: s/iter` (read to the
host only then); every `summary_interval` steps the losses and, with a
`val_loader`, one validation batch's losses written to
`<output_dir>/events.jsonl`; a snapshot every `snapshot_iters` steps,
one at each LR-decay boundary (train_val.py:353-355) and one at the end;
a fresh trainer resumes from the newest snapshot, with the loader's
iterators, numpy's RNG and the step generator as they were. With
`cfg.train.debug_save_dir`, each validation batch also leaves its first
example's response map and its 5 highest-energy backbone channels as PNGs
under `<dir>/response` and `<dir>/net_conv` (the reference's save=1 side
channel, nets/network.py:481-517).

A snapshot holds the loader state that follows the last batch a step
took, not the prefetcher's: each prefetched batch travels with the
loader's state after it, and the loader is rewound to the last consumed
one when the loop ends. So a resumed run takes the batches an
uninterrupted run would have taken.

Not ported (ROADMAP): `steps_per_dispatch > 1` (Queue 1 #4) and data
parallel training (Queue 1 #5).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data.prefetch import Prefetcher
from ..utils.timer import Timer
from .checkpoint import CheckpointManager, tolerant_restore
from .optimizer import set_lr
from .train_state import create_train_state, to_device, train_step

# loader entries the step does not take. `expr_uid` keys the JAX
# package's per-example draws so that they do not depend on how the
# expressions are batched or sharded (models/network.py:244-250); on one
# device the generator's draws are as random, only not invariant to the
# batch composition
TRAINER_HOST_KEYS = ("expr_uid",)


class MetricsWriter:
    """Append-only JSONL log of scalars (the reference's tensorboardX
    writers, train_val.py:209-210). Each record is appended and the file
    closed again, so a run holds no open handle between summaries."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path

    def scalars(self, step: int, values: Dict[str, float], tag: str = ""):
        rec = {"step": step, "tag": tag,
               **{k: float(v) for k, v in values.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _strip(batch: Dict) -> Dict:
    return {k: v for k, v in batch.items() if k not in TRAINER_HOST_KEYS}


class Trainer:
    """`loader` has `get_batch(split)`, `state_dict` and `load_state_dict`
    (data/loader.py::GtBatchLoader, data/synthetic.py::FixedBatchLoader).
    `output_dir=None` keeps no snapshots and no event log. The step's random draws come
    from one torch.Generator on the device, seeded from cfg.seed; weights
    from `state_dict` or weights.init_params(cfg, seed)."""

    def __init__(self, cfg: Config, loader, output_dir: Optional[str] = None,
                 val_loader=None, val_split: str = "val",
                 prefetch_depth: int = 2, device="cuda", state_dict=None,
                 seed: int = 0):
        t = cfg.train
        if t.steps_per_dispatch > 1:
            raise NotImplementedError(
                "steps_per_dispatch > 1 is not ported (ROADMAP Queue 1 #4)")
        if cfg.parallel.num_data > 1:
            raise NotImplementedError(
                "data parallel training is not ported (ROADMAP Queue 1 #5)")
        self.cfg = cfg
        self.state = create_train_state(cfg, device, state_dict, seed)
        self.device = next(self.state.model.parameters()).device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.loader = loader
        self.val_loader = val_loader
        self.val_split = val_split
        self.prefetch_depth = prefetch_depth
        self.ckpt = self.writer = None
        if output_dir is not None:
            self.ckpt = CheckpointManager(os.path.join(output_dir, "ckpt"),
                                          keep=t.snapshot_kept)
            self.writer = MetricsWriter(os.path.join(output_dir,
                                                     "events.jsonl"))
        self.timer = Timer()
        # the loader state after the last batch a step took
        self._loader_state = loader.state_dict()

    # ---- snapshot / resume (train_val.py:57-159) ----

    def snapshot(self, step: int) -> str:
        s = self.state
        return self.ckpt.save(step, {
            "model": s.model.state_dict(),
            "optimizer": s.optimizer.state_dict(),
            "step": s.step,
            "generator": self.generator.get_state()},
            {"loader_state": self._loader_state})

    def try_resume(self) -> Optional[int]:
        prev = self.ckpt.find_previous() if self.ckpt is not None else None
        if prev is None:
            return None
        state, host = self.ckpt.restore(prev, map_location=self.device)
        s = self.state
        s.model.load_state_dict(state["model"])
        s.optimizer.load_state_dict(state["optimizer"])
        s.step = int(state["step"])
        set_lr(s.optimizer, self.cfg, s.step)
        self.generator.set_state(state["generator"].cpu())
        self.loader.load_state_dict(host["loader_state"])
        self._loader_state = host["loader_state"]
        np.random.set_state(host["np_random_state"])
        print(f"resumed from snapshot iter_{prev}", flush=True)
        return prev

    def load_pretrained(self, state_dict: Dict[str, torch.Tensor]) -> Dict:
        """Tolerant transfer init (train_val.py:111-124): every entry
        whose key and shape match is copied. Returns what was skipped."""
        model = self.state.model
        merged, skipped = tolerant_restore(model.state_dict(), state_dict)
        model.load_state_dict(merged)
        print(f"pretrained: {len(merged) - len(skipped['missing']) - len(skipped['mismatched'])} "
              f"entries restored; skipped {len(skipped['missing'])} missing, "
              f"{len(skipped['mismatched'])} of another shape, "
              f"{len(skipped['unexpected'])} unexpected", flush=True)
        return skipped

    # ---- validation summaries (train_val.py:362-374) ----

    def _val_summary(self, it: int) -> Dict[str, float]:
        """One val batch through the loss forward, logged under
        tag="val". Its draws come from a generator of its own, seeded
        from cfg.seed ^ 0x5A1 with the iteration folded in (as JAX folds
        it into its key), so the training generator is untouched."""
        batch = to_device(_strip(self.val_loader.get_batch(self.val_split)),
                          self.device)
        g = torch.Generator(device=self.device)
        g.manual_seed(((self.cfg.seed ^ 0x5A1) << 32) | it)
        with torch.no_grad():
            losses = self.state.model.train_forward(batch, None, g)
        vals = {k: float(v) for k, v in losses.items()}
        self.writer.scalars(it, vals, tag="val")
        if self.cfg.train.debug_save_dir and self.cfg.model.use_language:
            self._debug_dump(it, batch)
        return vals

    def _debug_dump(self, it: int, batch: Dict[str, torch.Tensor]) -> None:
        """The first example of a validation batch: its response map as
        `<debug_save_dir>/response/iter<it>_0.png` and its 5 highest-energy
        backbone channels as `net_conv/iter<it>_0_<channel>.png`, from the
        backbone head and the conditioning in eval mode (two host reads a
        validation, none in a step)."""
        from ..utils.visualization import save_response_map, save_topk_channels
        model = self.state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                first = batch["img_idx"][:1].long()
                net_conv = model.backbone.head(model._images(
                    batch["images"].index_select(0, first)))
                _, response = model._condition(net_conv, batch["labels"][:1])
        finally:
            model.train(was_training)
        root = self.cfg.train.debug_save_dir
        save_response_map(response[0].float().cpu().numpy(),
                          os.path.join(root, "response"), f"iter{it}")
        save_topk_channels(net_conv[0].float().cpu().numpy(),
                           os.path.join(root, "net_conv"), f"iter{it}")

    # ---- main loop ----

    def _next_batch(self):
        return self.loader.get_batch("train"), self.loader.state_dict()

    def train(self, max_iters: Optional[int] = None,
              load_pretrained: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, float]:
        """Step until the state has taken `max_iters` steps (default
        cfg.train.max_iters). A fresh trainer first resumes from the
        newest snapshot, else takes `load_pretrained`. Returns the losses
        last printed."""
        t = self.cfg.train
        max_iters = max_iters or t.max_iters
        if self.state.step == 0 and not self.try_resume() \
                and load_pretrained is not None:
            self.load_pretrained(load_pretrained)
        start = self.state.step
        next_decay = [s for s in t.stepsize if s > start]
        last: Dict[str, float] = {}
        prefetcher = Prefetcher(self._next_batch, depth=self.prefetch_depth)
        try:
            while self.state.step < max_iters:
                self.timer.tic("step")
                batch, loader_state = prefetcher.get()
                losses = train_step(self.state,
                                    to_device(_strip(batch), self.device),
                                    self.generator)
                self._loader_state = loader_state
                it = self.state.step
                host = None
                if it % t.display == 0 or it == max_iters:
                    host = last = {k: float(v) for k, v in losses.items()}
                    dt = self.timer.toc("step")
                    msg = ", ".join(f"{k}={v:.4f}"
                                    for k, v in sorted(last.items()))
                    print(f"iter {it}/{max_iters}: {msg}, "
                          f"speed: {dt:.3f}s/iter", flush=True)
                if self.writer is not None and it % t.summary_interval == 0:
                    self.writer.scalars(it, host or {
                        k: float(v) for k, v in losses.items()})
                    if self.val_loader is not None:
                        self._val_summary(it)
                if self.ckpt is not None:
                    if next_decay and it == next_decay[0]:
                        self.snapshot(it)
                        next_decay.pop(0)
                    elif it % t.snapshot_iters == 0:
                        self.snapshot(it)
        finally:
            prefetcher.close()
            self.loader.load_state_dict(self._loader_state)
        if self.ckpt is not None and self.state.step > start and \
                self.state.step % t.snapshot_iters != 0:
            self.snapshot(self.state.step)
        return last
