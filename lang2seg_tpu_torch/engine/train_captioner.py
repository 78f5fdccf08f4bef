"""Captioner pretraining.

Counterpart of `lang2seg_tpu/engine/train_captioner.py`. The reference
trains the captioner on its own (README steps 3 and 5:
`caption_log_res5_2/`, `caption_log_response/` produce `model-best.pth`,
which `caption_models/__init__.py:45-52` restores into the cycle
network). Here: region features from the network's backbone
(`extract_caption_features`), teacher-forced steps of the captioner on
Adam (optax.adam's defaults: lr 5e-4, betas (0.9, 0.999), eps 1e-8), the
reference's scheduled-sampling annealing, a validation NLL with the best
checkpoint kept (`torch.save` of the `caption_model.*` state_dict), and
`restore_captioner`, which grafts that checkpoint into a full state_dict.
Any decoder of `models/caption_zoo.py::setup_captioner` trains here; the
zoo's decoders other than att2in2 have no scheduled sampling and raise
for a probability above 0.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..device import resolve_device
from ..models.caption_zoo import setup_captioner
from ..models.network import Lang2Seg

PREFIX = "caption_model."


@torch.no_grad()
def extract_caption_features(model: Lang2Seg, batch: Dict[str, torch.Tensor]
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 'res5_2' pairing (network_cycle_res5_2.py:415-448): each
    expression's image map and its GT-masked copy through the layer4 tail
    -> (fc (E, 4096), att (E, 196, 4096)) f32, on the model's device.
    batch: images, img_idx, gt_masks as `Lang2Seg.train_forward` takes
    them."""
    images = model._images(batch["images"])
    net_conv = model.resnet.head(images).index_select(
        0, batch["img_idx"].long())
    gt_masks = model._gt_masks(batch["gt_masks"], images.shape[2])
    return model.caption_features(net_conv,
                                  model.gt_masked_map(net_conv, gt_masks))


def scheduled_sampling_prob(epoch: int, start: int = -1,
                            increase_every: int = 5,
                            increase_prob: float = 0.05,
                            max_prob: float = 0.25) -> float:
    """Scheduled-sampling annealing (reference flags opt_cycle.py:106-109):
    off until `start`, then up by `increase_prob` every `increase_every`
    epochs, capped at `max_prob`."""
    if start < 0 or epoch < start:
        return 0.0
    frac = (epoch - start) // increase_every
    return min(increase_prob * frac, max_prob)


@dataclass
class CaptionerTrainState:
    captioner: nn.Module             # a decoder of setup_captioner
    optimizer: torch.optim.Adam
    generator: torch.Generator       # dropout and scheduled-sampling draws
    step: int = 0


def init_captioner_state(cfg: Config, device="cuda", seed: int = 0,
                         lr: float = 5e-4) -> CaptionerTrainState:
    """The captioner of cfg.model on `device` (default the card; raises
    without one) in train mode, with weights.init_captioner_params(cfg,
    seed), its Adam optimizer and a generator on the device seeded from
    cfg.seed."""
    from ..weights import init_captioner_params
    dev = resolve_device(device)
    with torch.device("meta"):
        captioner = setup_captioner(cfg.model)
    captioner = captioner.to_empty(device=dev)
    sd = init_captioner_params(cfg, seed)
    captioner.load_state_dict(
        {k[len(PREFIX):]: v for k, v in sd.items()}, strict=True)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    return CaptionerTrainState(
        captioner.train(), torch.optim.Adam(captioner.parameters(), lr=lr),
        gen)


def captioner_train_step(state: CaptionerTrainState, fc, att, seq, mask,
                         ss_prob: float = 0.0) -> torch.Tensor:
    """One Adam step on the teacher-forced NLL of a feature batch on the
    captioner's device. Reads nothing back to the host; returns the loss
    as a device scalar."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = state.captioner.teacher_forced_nll(fc, att, seq, mask,
                                              state.generator, ss_prob)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


@torch.no_grad()
def validation_nll(captioner: nn.Module, fc, att, seq, mask) -> float:
    """The teacher-forced NLL in eval mode (no dropout, no sampling)."""
    was_training = captioner.training
    captioner.eval()
    try:
        return float(captioner.teacher_forced_nll(fc, att, seq, mask))
    finally:
        captioner.train(was_training)


def run_captioner_training(cfg: Config, batch_iter: Iterator,
                           max_iters: int, iters_per_epoch: int = 1,
                           val_iter: Optional[Iterator] = None,
                           val_every: int = 0,
                           ckpt_dir: Optional[str] = None, device="cuda",
                           seed: int = 0) -> Dict:
    """Captioner pretraining with the reference's scheduled-sampling
    annealing (cfg.model.cap_ss_*, epoch-indexed) and best-validation
    tracking (README step 3: model-best.pth). `batch_iter` and `val_iter`
    yield (fc, att, seq, mask) feature batches on the device; every
    `val_every` steps one validation batch is scored and, when it is the
    best so far and `ckpt_dir` is given, the captioner is saved there as
    `model-best.pth` (its state_dict under `caption_model.*` keys)."""
    m = cfg.model
    state = init_captioner_state(cfg, device, seed)
    best_val, history = math.inf, []
    for it in range(max_iters):
        epoch = it // max(iters_per_epoch, 1)
        p = scheduled_sampling_prob(epoch, m.cap_ss_start,
                                    m.cap_ss_increase_every,
                                    m.cap_ss_increase_prob, m.cap_ss_max_prob)
        loss = captioner_train_step(state, *next(batch_iter), ss_prob=p)
        history.append({"iter": it, "epoch": epoch, "ss_prob": p,
                        "loss": float(loss)})
        if val_every and val_iter is not None and (it + 1) % val_every == 0:
            vl = validation_nll(state.captioner, *next(val_iter))
            if vl < best_val:
                best_val = vl
                if ckpt_dir is not None:
                    os.makedirs(ckpt_dir, exist_ok=True)
                    torch.save(captioner_state_dict(state.captioner),
                               os.path.join(ckpt_dir, "model-best.pth"))
    return {"state": state, "history": history, "best_val": best_val}


def captioner_state_dict(captioner: nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """The captioner's weights on the CPU under the network's
    `caption_model.*` keys."""
    return {PREFIX + k: v.detach().cpu().clone()
            for k, v in captioner.state_dict().items()}


def load_captioner_file(path: str, allow_pickle: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """A captioner checkpoint under `caption_model.*` keys: the port's
    `model-best.pth`, the reference's (its captioner's own state_dict,
    bare keys, or one with the prefix), or the JAX package's
    `model-best.npz` (the captioner's params tree, through
    `weights.captioner_from_jax`). `allow_pickle`: see
    `engine/convert.py`."""
    from .convert import load_npz_tree, load_torch_file
    from ..weights import captioner_from_jax
    if path.endswith(".npz"):
        return dict(captioner_from_jax(load_npz_tree(path)))
    loaded = load_torch_file(path, allow_pickle)
    if not any(k.startswith(PREFIX) for k in loaded):
        loaded = {PREFIX + k: v for k, v in loaded.items()}
    return loaded


def restore_captioner(state_dict: Dict[str, torch.Tensor], path: str,
                      allow_pickle: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """Graft a pretrained captioner checkpoint (`load_captioner_file`)
    into a full network state_dict: the reference's README step 5 restore
    of caption_log_*/model-best.pth into the cycle network. The
    checkpoint must hold exactly the state_dict's `caption_model.*` keys
    with the same shapes; they take its values in each entry's dtype and
    device, and every other entry is returned untouched."""
    want = {k: v for k, v in state_dict.items() if k.startswith(PREFIX)}
    if not want:
        raise ValueError("state_dict has no caption_model.* entries (not a "
                         "cycle variant?)")
    loaded = load_captioner_file(path, allow_pickle)
    if set(loaded) != set(want):
        raise ValueError(f"captioner checkpoint keys differ: missing "
                         f"{sorted(set(want) - set(loaded))}, unexpected "
                         f"{sorted(set(loaded) - set(want))}")
    for k, v in want.items():
        if tuple(loaded[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: checkpoint shape "
                             f"{tuple(loaded[k].shape)}, network "
                             f"{tuple(v.shape)}")
    out = dict(state_dict)
    for k, v in want.items():
        out[k] = loaded[k].to(dtype=v.dtype, device=v.device)
    return out
