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

Several steps a dispatch (cfg.train.steps_per_dispatch K > 1), as the JAX
Trainer groups them: K steps go to one `make_multi_train_step` call (a
CUDA graph replayed K times on the card) when they fit before the next
boundary (snapshot, LR decay, end of run), else single steps up to it, so
snapshots land exactly on cadence; the prefetcher keeps K + 1 batches
ahead; a group's losses are read to the host once, and only when a
display or a summary falls in it.

Data parallel (cfg.parallel.num_data n > 1, under an initialised process
group, `parallel/mesh.py`): each rank takes its block of every batch
(`get_batch("train", num_shards=n, shard=rank)`, with `expr_uid`) through
`parallel/train.py`'s sharded steps, with its own dropout generator and
the shared sampling generator; rank 0 alone prints, writes the event log
and writes snapshots, which hold every rank's dropout generator, and
every rank resumes from the same snapshot.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..data.prefetch import Prefetcher
from ..parallel import train as ptrain
from ..parallel.mesh import make_mesh
from ..utils.timer import Timer
from ..utils.trace import span
from .checkpoint import CheckpointManager, tolerant_restore
from .optimizer import set_lr
from .train_state import (create_train_state, make_multi_train_step,
                          stack_batches, to_device, train_step)

# loader entries the step does not take. `expr_uid` keys the JAX
# package's per-example draws so that they do not depend on how the
# expressions are batched or sharded (models/network.py:244-250); on one
# device the generator's draws are as random, only not invariant to the
# batch composition (the data-parallel Trainer keeps it)
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
    from `state_dict` or weights.init_params(cfg, seed). With
    cfg.parallel.num_data > 1 the Trainer is one rank of `mesh` (default
    `parallel.make_mesh`, which raises without a process group) and runs
    on the mesh's device; the loader then also takes `num_shards` and
    `shard`."""

    def __init__(self, cfg: Config, loader, output_dir: Optional[str] = None,
                 val_loader=None, val_split: str = "val",
                 prefetch_depth: int = 2, device="cuda", state_dict=None,
                 seed: int = 0, mesh=None):
        t = cfg.train
        self.cfg = cfg
        self.steps_per_dispatch = max(1, t.steps_per_dispatch)
        self.num_shards = max(1, cfg.parallel.num_data)
        self.mesh = None
        if self.num_shards > 1:
            self.mesh = mesh or make_mesh(self.num_shards)
            if self.mesh.size != self.num_shards:
                raise ValueError(f"num_data {self.num_shards} but the mesh "
                                 f"has {self.mesh.size} ranks")
            device = self.mesh.device
        self.state = create_train_state(cfg, device, state_dict, seed)
        self.device = next(self.state.model.parameters()).device
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.sampling_generator = None
        if self.mesh is None:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(cfg.seed)
            self.multi_step = make_multi_train_step(
                self.state, self.generator) \
                if self.steps_per_dispatch > 1 else None
        else:
            ptrain.sync_replicas(self.state.model, self.mesh)
            self.generator = ptrain.dropout_generator(
                cfg.seed, self.mesh.rank, self.device)
            self.sampling_generator = ptrain.sampling_generator(
                cfg.seed, self.device)
            self._sharded_step = ptrain.make_sharded_train_step(
                self.state, self.mesh, self.generator,
                self.sampling_generator)
            self.multi_step = ptrain.make_sharded_multi_step(
                self.state, self.mesh, self.generator,
                self.sampling_generator) \
                if self.steps_per_dispatch > 1 else None
        self.loader = loader
        self.val_loader = val_loader
        self.val_split = val_split
        self.prefetch_depth = prefetch_depth
        self.ckpt = self.writer = None
        if output_dir is not None:
            self.ckpt = CheckpointManager(os.path.join(output_dir, "ckpt"),
                                          keep=t.snapshot_kept)
            if self.is_main:
                self.writer = MetricsWriter(os.path.join(output_dir,
                                                         "events.jsonl"))
        self.timer = Timer()
        # the loader state after the last batch a step took
        self._loader_state = loader.state_dict()

    def _print(self, msg: str) -> None:
        if self.is_main:
            print(msg, flush=True)

    # ---- snapshot / resume (train_val.py:57-159) ----

    def snapshot(self, step: int) -> Optional[str]:
        """Rank 0 writes the snapshot (every rank calls this: a
        data-parallel run gathers every rank's dropout generator)."""
        s = self.state
        state = {"model": s.model.state_dict(),
                 "optimizer": s.optimizer.state_dict(),
                 "step": s.step,
                 "generator": self.generator.get_state()}
        if self.mesh is not None:
            gens = [None] * self.mesh.size
            dist.all_gather_object(gens, self.generator.get_state(),
                                   group=self.mesh.group)
            state["generators"] = gens
            state["sampling_generator"] = self.sampling_generator.get_state()
        if not self.is_main:
            return None
        return self.ckpt.save(step, state,
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
        if self.mesh is not None:
            if len(state.get("generators", ())) != self.mesh.size:
                raise ValueError(
                    f"snapshot iter_{prev} holds no dropout generators for "
                    f"{self.mesh.size} ranks")
            self.generator.set_state(state["generators"][self.mesh.rank].cpu())
            self.sampling_generator.set_state(
                state["sampling_generator"].cpu())
        else:
            self.generator.set_state(state["generator"].cpu())
        self.loader.load_state_dict(host["loader_state"])
        self._loader_state = host["loader_state"]
        np.random.set_state(host["np_random_state"])
        self._print(f"resumed from snapshot iter_{prev}")
        return prev

    def load_pretrained(self, state_dict: Dict[str, torch.Tensor]) -> Dict:
        """Tolerant transfer init (train_val.py:111-124): every entry
        whose key and shape match is copied. Returns what was skipped."""
        model = self.state.model
        merged, skipped = tolerant_restore(model.state_dict(), state_dict)
        model.load_state_dict(merged)
        self._print(
            f"pretrained: {len(merged) - len(skipped['missing']) - len(skipped['mismatched'])} "
            f"entries restored; skipped {len(skipped['missing'])} missing, "
            f"{len(skipped['mismatched'])} of another shape, "
            f"{len(skipped['unexpected'])} unexpected")
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

    @span("l2s.loader")
    def _next_batch(self):
        if self.mesh is None:
            batch = _strip(self.loader.get_batch("train"))
        else:
            batch = self.loader.get_batch("train", num_shards=self.num_shards,
                                          shard=self.mesh.rank)
        return batch, self.loader.state_dict()

    def _dispatch(self, batches) -> Dict[str, torch.Tensor]:
        """One group's steps: a single step's scalar losses, or K steps'
        (K,) losses from one multi-step call."""
        with span("l2s.upload"):
            batch = to_device(stack_batches(batches) if len(batches) > 1
                              else batches[0], self.device)
        if len(batches) > 1:
            return self.multi_step(batch)
        if self.mesh is None:
            return train_step(self.state, batch, self.generator)
        return self._sharded_step(batch)

    @span("l2s.train")
    def train(self, max_iters: Optional[int] = None,
              load_pretrained: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, float]:
        """Step until the state has taken `max_iters` steps (default
        cfg.train.max_iters). A fresh trainer first resumes from the
        newest snapshot, else takes `load_pretrained`. Returns the losses
        last printed (on every rank: the losses are the ranks' mean)."""
        t = self.cfg.train
        max_iters = max_iters or t.max_iters
        if self.state.step == 0 and not self.try_resume() \
                and load_pretrained is not None:
            self.load_pretrained(load_pretrained)
            if self.mesh is not None:
                ptrain.sync_replicas(self.state.model, self.mesh)
        start = self.state.step
        next_decay = [s for s in t.stepsize if s > start]
        k_cfg = self.steps_per_dispatch

        def next_boundary(i: int) -> int:
            """The first step after `i` at which a snapshot, an LR-decay
            snapshot or the end of the run falls: no group crosses it."""
            b = (i // t.snapshot_iters + 1) * t.snapshot_iters
            if next_decay:
                b = min(b, next_decay[0])
            return min(b, max_iters)

        last: Dict[str, float] = {}
        prefetcher = Prefetcher(self._next_batch,
                                depth=max(self.prefetch_depth, k_cfg + 1))
        try:
            while self.state.step < max_iters:
                with span("l2s.step"):
                    it = self.state.step
                    k = k_cfg if it + k_cfg <= next_boundary(it) else 1
                    self.timer.tic("step")
                    with span("l2s.wait.batch"):
                        items = [prefetcher.get() for _ in range(k)]
                    losses = self._dispatch([b for b, _ in items])
                    self._loader_state = items[-1][1]
                    host = None
                    group_dt = None
                    for j in range(k):
                        it += 1
                        if it % t.display == 0 or it == max_iters or (
                                self.writer is not None
                                and it % t.summary_interval == 0):
                            if host is None:
                                # the group's one read back to the host
                                with span("l2s.sync.losses"):
                                    host = {n: v.cpu().numpy().reshape(-1)
                                            for n, v in losses.items()}
                            vals = {n: float(v[j if k > 1 else 0])
                                    for n, v in host.items()}
                        if it % t.display == 0 or it == max_iters:
                            last = vals
                            if group_dt is None:
                                group_dt = self.timer.toc("step") / k
                            msg = ", ".join(f"{n}={v:.4f}"
                                            for n, v in sorted(last.items()))
                            self._print(f"iter {it}/{max_iters}: {msg}, "
                                        f"speed: {group_dt:.3f}s/iter")
                        if self.writer is not None and \
                                it % t.summary_interval == 0:
                            self.writer.scalars(it, vals)
                            if self.val_loader is not None:
                                self._val_summary(it)
                        # the LR-decay snapshot, then the cadence (groups end
                        # at both, so they fall on a group's last step)
                        if next_decay and it == next_decay[0]:
                            next_decay.pop(0)
                            if self.ckpt is not None:
                                self.snapshot(it)
                        elif self.ckpt is not None and \
                                it % t.snapshot_iters == 0:
                            self.snapshot(it)
        finally:
            prefetcher.close()
            self.loader.load_state_dict(self._loader_state)
        if self.ckpt is not None and self.state.step > start and \
                self.state.step % t.snapshot_iters != 0:
            self.snapshot(self.state.step)
        return last
