"""SGD with the reference's per-group learning rates.

Counterpart of `lang2seg_tpu/engine/optimizer.py::build_optimizer`
(reference SolverWrapper, `model/train_val.py:188-207`):
  * frozen parameters (requires_grad=False: the stem conv1, layer1 ..
    layer{fixed_blocks}, or VGG16's conv1_* and conv2_*; the frozen
    BatchNorms are buffers) get no update;
  * the language encoder and the filter generator (`rnn_encoder.*`,
    `dynamic_fc*`, `response_fc`) get `lang_lr_mult` x LR;
  * biases get LR x (1 + double_bias) and no weight decay unless
    bias_decay; everything else the base LR and `weight_decay`.
    A bias is what the JAX tree names `bias*`: the captioner keeps most
    of its biases as raw params named `*_b` (`logit_b`, `a2c_b`, ...),
    which JAX counts as weights, so their reference layers' `.bias`
    entries (`CAPTIONER_RAW_BIASES`) are weights here too; the
    captioner's `fc_embed`, `att_embed` and `ctx2att` biases are biases.

The JAX chain is clip_by_global_norm (when grad_clip_norm > 0), then
add_decayed_weights, trace (momentum), the group multiplier and the LR.
torch SGD applies weight decay, then the momentum trace, then its group's
LR, so the multiplier rides in each group's LR: `set_lr` writes
lr_schedule(step) x multiplier into every group before a step.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
from torch import nn

from ..config import Config

_LANG_PREFIXES = ("rnn_encoder.", "dynamic_fc", "response_fc.")


# captioner biases that the JAX tree holds as raw `*_b` params
CAPTIONER_RAW_BIASES = tuple(
    f"caption_model.{layer}.bias" for layer in (
        "logit", "core.i2h", "core.h2h", "core.a2c", "core.attention.h2att",
        "core.attention.alpha_net"))


def _is_bias(name: str) -> bool:
    return (name.rsplit(".", 1)[-1].startswith("bias")
            and name not in CAPTIONER_RAW_BIASES)


def param_groups(model: nn.Module, cfg: Config) -> List[Dict]:
    """One group per (LR multiplier, weight decay), in first-seen order;
    each carries its `lr_mult` and its parameters' `names`."""
    t = cfg.train
    groups: Dict[Tuple[float, float], Dict] = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        mult = t.lang_lr_mult if name.startswith(_LANG_PREFIXES) else 1.0
        bias = _is_bias(name)
        if bias and t.double_bias:
            mult *= 2.0
        decay = 0.0 if bias and not t.bias_decay else t.weight_decay
        g = groups.setdefault((mult, decay), {
            "params": [], "names": [], "lr_mult": mult,
            "weight_decay": decay})
        g["params"].append(p)
        g["names"].append(name)
    return list(groups.values())


def lr_schedule(cfg: Config, step: int) -> float:
    """Piecewise constant: the base LR times gamma for each stepsize
    boundary that `step` (updates done so far) has reached, as
    optax.piecewise_constant_schedule counts."""
    t = cfg.train
    return t.learning_rate * t.gamma ** sum(step >= int(s)
                                            for s in t.stepsize)


def build_optimizer(model: nn.Module, cfg: Config) -> torch.optim.SGD:
    t = cfg.train
    return torch.optim.SGD(param_groups(model, cfg), lr=t.learning_rate,
                           momentum=t.momentum, dampening=0.0,
                           nesterov=False)


def set_lr(optimizer: torch.optim.Optimizer, cfg: Config, step: int) -> None:
    lr = lr_schedule(cfg, step)
    for g in optimizer.param_groups:
        g["lr"] = lr * g["lr_mult"]


def _l2_norm(g: torch.Tensor) -> torch.Tensor:
    """The L2 norm of a tensor, over each row (the leading index) first
    and then over the rows: the CPU's `vector_norm` accumulates a whole
    tensor in f32 and is off by ~1% over VGG16's 102M-element fc6
    gradient, where the card's and XLA's reductions are not."""
    if g.dim() > 1:
        g = torch.linalg.vector_norm(g, dim=tuple(range(1, g.dim())))
    return torch.linalg.vector_norm(g)


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global L2 norm of all
    grads reaches max_norm, each becomes (g / norm) * max_norm. Decided
    on the device (no host synchronisation). Returns the norm."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(torch.stack([_l2_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
