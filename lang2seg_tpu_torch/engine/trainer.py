"""Training driver.

Counterpart of `lang2seg_tpu/engine/trainer.py::Trainer` (reference
SolverWrapper.train_model, `model/train_val.py:308-409`), reduced to the
loop: one SGD step per batch of (images x expressions), the losses
printed every `cfg.train.display` steps with `speed: s/iter`. The losses
are read to the host only on those steps. Snapshots and resume,
validation summaries, debug dumps and the real data loader are not
ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

import torch

from ..config import Config
from .train_state import create_train_state, to_device, train_step


class Trainer:
    """`loader` is an iterable of batches (dicts of numpy arrays or
    tensors, the layout of `Lang2Seg.train_forward`). The step's random
    draws come from one torch.Generator on the device, seeded from
    cfg.seed."""

    def __init__(self, cfg: Config, loader: Iterable, device="cuda",
                 state_dict=None, seed: int = 0):
        self.cfg = cfg
        self.state = create_train_state(cfg, device, state_dict, seed)
        self.device = next(self.state.model.parameters()).device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self._batches = iter(loader)

    def train(self, max_iters: Optional[int] = None) -> Dict[str, float]:
        """Step until the state has taken `max_iters` steps (default
        cfg.train.max_iters). Returns the losses last printed."""
        t = self.cfg.train
        max_iters = max_iters or t.max_iters
        last: Dict[str, float] = {}
        t0, since = time.perf_counter(), 0
        while self.state.step < max_iters:
            batch = to_device(next(self._batches), self.device)
            losses = train_step(self.state, batch, self.generator)
            since += 1
            it = self.state.step
            if it % t.display == 0 or it == max_iters:
                last = {k: float(v) for k, v in losses.items()}
                dt = (time.perf_counter() - t0) / since
                msg = ", ".join(f"{k}={v:.4f}"
                                for k, v in sorted(last.items()))
                print(f"iter {it}/{max_iters}: {msg}, speed: {dt:.3f}s/iter",
                      flush=True)
                t0, since = time.perf_counter(), 0
        return last
