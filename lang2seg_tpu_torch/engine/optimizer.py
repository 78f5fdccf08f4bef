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

A graph-replayable update (`SGD`): each group's LR also lives in a device
tensor that `set_lr` fills in place, and the update reads it, so a step
captured in a CUDA graph (`engine/train_state.py::make_multi_train_step`)
meets every LR boundary. The update is torch's SGD with its last
operation, `p += -lr * buf`, taken as `p.addcmul_(buf, -lr)` on the 0-dim
LR tensor: bit for bit torch's step with the LR as a float, on the CPU
(tests/test_torch_multistep.py) and on the card against its foreach step
(chip_smoke.py phase 28).
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


class SGD(torch.optim.SGD):
    """torch SGD (momentum, no dampening, no Nesterov) whose groups' LRs
    are also 0-dim f32 tensors on the parameters' device (`neg_lr`, each
    holding -lr), filled by `fill_lr`. `step` reads them and reads nothing
    back to the host, so a captured step replays with the LR of the
    moment. The state dict is torch SGD's."""

    def __init__(self, params, lr: float, momentum: float):
        super().__init__(params, lr=lr, momentum=momentum, dampening=0.0,
                         nesterov=False)
        dev = self.param_groups[0]["params"][0].device
        self.neg_lr = [torch.zeros((), dtype=torch.float32, device=dev)
                       for _ in self.param_groups]
        self._filled = [None] * len(self.param_groups)
        self.fill_lr()

    def fill_lr(self) -> None:
        """Each group's `lr` into its tensor, where it changed (a fill
        kernel on the current stream, no host synchronisation)."""
        for i, g in enumerate(self.param_groups):
            if self._filled[i] != g["lr"]:
                self.neg_lr[i].fill_(-g["lr"])
                self._filled[i] = g["lr"]

    @torch.no_grad()
    def step(self, closure=None):
        for g, neg_lr in zip(self.param_groups, self.neg_lr):
            params = [p for p in g["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if g["weight_decay"] != 0:
                grads = torch._foreach_add(grads, params,
                                           alpha=g["weight_decay"])
            bufs = [self.state[p].get("momentum_buffer") for p in params]
            if all(b is not None for b in bufs):
                torch._foreach_mul_(bufs, g["momentum"])
                torch._foreach_add_(bufs, grads)
            else:
                # the first step: torch's own buffers, cloned gradients
                for i, (p, b) in enumerate(zip(params, bufs)):
                    if b is None:
                        bufs[i] = self.state[p]["momentum_buffer"] = \
                            grads[i].detach().clone()
                    else:
                        b.mul_(g["momentum"]).add_(grads[i])
            for p, b in zip(params, bufs):
                p.addcmul_(b, neg_lr)
        return None


def build_optimizer(model: nn.Module, cfg: Config) -> SGD:
    t = cfg.train
    return SGD(param_groups(model, cfg), lr=t.learning_rate,
               momentum=t.momentum)


def set_lr(optimizer: torch.optim.Optimizer, cfg: Config, step: int) -> None:
    """Each group's LR for the update after `step` updates, into its
    `lr` and, for the port's `SGD`, into its device tensor."""
    lr = lr_schedule(cfg, step)
    for g in optimizer.param_groups:
        g["lr"] = lr * g["lr_mult"]
    if isinstance(optimizer, SGD):
        optimizer.fill_lr()


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
