"""Train state and the SGD step.

Counterpart of `lang2seg_tpu/engine/train_state.py` (`create_train_state`,
`train_step_body`): one step is the forward with its losses, the backward
and the per-group SGD update (`engine/optimizer.py`). The step issues its
work on the current stream and reads nothing back to the host; the
losses return as device tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models.network import Lang2Seg, build_model
from .optimizer import build_optimizer, clip_by_global_norm_, set_lr

# host-side entries of a loader batch that the step does not take
HOST_KEYS = ("wrapped", "im_scales")


@dataclass
class TrainState:
    model: Lang2Seg
    optimizer: torch.optim.SGD
    step: int = 0          # updates done; the LR schedule's count


def create_train_state(cfg: Config, device="cuda", state_dict=None,
                       seed: int = 0) -> TrainState:
    """The model on `device` (default the card; raises without one) in
    train mode, with weights from `state_dict` (reference keys) or drawn
    by weights.init_params(cfg, seed), and its SGD optimizer."""
    model = build_model(cfg, device=resolve_device(device),
                        state_dict=state_dict, seed=seed).train()
    return TrainState(model, build_optimizer(model, cfg))


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy arrays or tensors) as tensors on `device`,
    without its host-side entries."""
    out = {}
    for k, v in batch.items():
        if k in HOST_KEYS:
            continue
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device)
    return out


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator],
               targets: Optional[Tuple] = None) -> Dict[str, torch.Tensor]:
    """One SGD step on a batch already on the model's device; `generator`
    draws the step's dropout mask and sampling priorities, `targets`
    optionally injects (AnchorTargets, ProposalTargets). Returns the
    detached losses on the device."""
    state.optimizer.zero_grad(set_to_none=True)
    losses = state.model.train_forward(batch, targets, generator)
    losses["total_loss"].backward()
    apply_update(state)
    return {k: v.detach() for k, v in losses.items()}


def apply_update(state: TrainState) -> None:
    """The SGD update from the gradients the backward left: clipping by
    the global norm (when cfg.train.grad_clip_norm > 0), then each group's
    weight decay, momentum and LR at the schedule's current step."""
    cfg = state.model.cfg
    opt = state.optimizer
    grads = []
    for g in opt.param_groups:
        for p in g["params"]:
            if p.grad is None:
                # a parameter this batch did not reach: a zero gradient,
                # so weight decay and momentum still act, as in JAX
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    if cfg.train.grad_clip_norm and cfg.train.grad_clip_norm > 0:
        clip_by_global_norm_(grads, cfg.train.grad_clip_norm)
    set_lr(opt, cfg, state.step)
    opt.step()
    state.step += 1
