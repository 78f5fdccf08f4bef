"""Train state, the SGD step, and several steps a dispatch.

Counterpart of `lang2seg_tpu/engine/train_state.py` (`create_train_state`,
`train_step_body`, `make_multi_train_step`, `stack_batches`): one step is
the forward with its losses, the backward and the per-group SGD update
(`engine/optimizer.py`). The step issues its work on the current stream
and reads nothing back to the host; the losses return as device tensors.

Several steps a dispatch (`make_multi_train_step`), JAX's `lax.scan` over
the step body: on the card one whole step (zeroing the gradients, the
forward, the backward with the hand kernels' nodes, the update) is
captured once in a `torch.cuda.CUDAGraph` after a warm step, and a
dispatch of K batches copies each batch into the graph's static input
buffers and replays it, K replays with no host read between them. The
LR is a device tensor filled before each replay (`optimizer.SGD`), the
step's generators are registered with the graph, so each replay draws and
updates what the eager step would. On the CPU the same call takes K eager
steps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import capture_graph, resolve_device
from ..models.network import Lang2Seg, build_model
from ..utils import trace
from ..utils.trace import span
from .optimizer import build_optimizer, clip_by_global_norm_, set_lr

# host-side entries of a loader batch that the step does not take
HOST_KEYS = ("wrapped", "im_scales")

# gradients and losses of a step -> their data-parallel means, in place
# for the gradients (parallel/train.py::pmean_hook)
ReduceFn = Callable[[List[torch.Tensor], Dict[str, torch.Tensor]],
                    Dict[str, torch.Tensor]]


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


def stack_batches(batches: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """K host batches stacked entry-wise onto a leading step axis for
    `make_multi_train_step`, without their host-side entries (one upload
    an entry)."""
    keys = [k for k in batches[0] if k not in HOST_KEYS]
    return {k: np.stack([np.asarray(b[k]) for b in batches]) for k in keys}


def _forward_backward(state: TrainState, batch: Dict[str, torch.Tensor],
                      generator, targets=None, sampling_generator=None
                      ) -> Dict[str, torch.Tensor]:
    with span("l2s.forward"):
        state.optimizer.zero_grad(set_to_none=True)
        losses = state.model.train_forward(batch, targets, generator,
                                           sampling_generator)
    with span("l2s.backward"):
        losses["total_loss"].backward()
    return {k: v.detach() for k, v in losses.items()}


def _grads(state: TrainState) -> List[torch.Tensor]:
    """Every trainable parameter's gradient, in group order; a parameter
    this batch did not reach gets a zero gradient, so that weight decay
    and momentum still act, as in JAX."""
    grads = []
    for g in state.optimizer.param_groups:
        for p in g["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    return grads


def _clip_and_step(state: TrainState, grads: List[torch.Tensor]) -> None:
    clip = state.model.cfg.train.grad_clip_norm
    if clip and clip > 0:
        clip_by_global_norm_(grads, clip)
    state.optimizer.step()


def _step_body(state: TrainState, batch: Dict[str, torch.Tensor],
               generator, targets=None, sampling_generator=None,
               reduce: Optional[ReduceFn] = None
               ) -> Dict[str, torch.Tensor]:
    """One step at the LR already filled, without the step count: what a
    graph captures."""
    losses = _forward_backward(state, batch, generator, targets,
                               sampling_generator)
    with span("l2s.optimizer"):
        grads = _grads(state)
        if reduce is not None:
            losses = reduce(grads, losses)
        _clip_and_step(state, grads)
    return losses


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator],
               targets: Optional[Tuple] = None,
               sampling_generator: Optional[torch.Generator] = None,
               reduce: Optional[ReduceFn] = None
               ) -> Dict[str, torch.Tensor]:
    """One SGD step on a batch already on the model's device; `generator`
    draws the step's dropout masks and sampling priorities (with
    `expr_uid` in the batch, the per-step sampling key comes from
    `sampling_generator` when given), `targets` optionally injects
    (AnchorTargets, ProposalTargets), `reduce` averages the gradients and
    losses over data-parallel ranks. Returns the detached losses on the
    device."""
    set_lr(state.optimizer, state.model.cfg, state.step)
    losses = _step_body(state, batch, generator, targets, sampling_generator,
                        reduce)
    state.step += 1
    return losses


def apply_update(state: TrainState) -> None:
    """The SGD update from the gradients the backward left: clipping by
    the global norm (when cfg.train.grad_clip_norm > 0), then each group's
    weight decay, momentum and LR at the schedule's current step."""
    grads = _grads(state)
    set_lr(state.optimizer, state.model.cfg, state.step)
    _clip_and_step(state, grads)
    state.step += 1


class MultiStep:
    """K SGD steps a call (`make_multi_train_step`). `batches` holds each
    entry with a leading step axis K (`stack_batches`, then `to_device`);
    returns every loss with that axis, as device tensors.

    On a CUDA device the step is a CUDA graph: the first call takes its
    first batch through the eager step (the warm step, which creates the
    momentum buffers and the kernels' cached launch state, and counts as a
    step), captures the step on the shapes of that batch, and replays it
    for the rest; later calls replay it for every batch. A batch of other
    shapes or dtypes raises, and so does a capture that fails. On the CPU
    the call takes K eager steps. `capture_s` holds the capture's wall
    time. The hand kernels' launches count as the kernels run
    (`utils/trace.py`): the warm step's as an eager step's, the capture's
    not at all, and each replay adds the capture's record."""

    def __init__(self, state: TrainState, generator, sampling_generator=None,
                 reduce: Optional[ReduceFn] = None):
        self.state = state
        self.generator = generator
        self.sampling_generator = sampling_generator
        self.reduce = reduce
        self.graphed = next(state.model.parameters()).device.type == "cuda"
        self.graph = None
        self.record = None
        self.capture_s = None
        self._static: Dict[str, torch.Tensor] = {}
        self._keys: List[str] = []
        self._loss_vec = None

    def _eager(self, batch, targets=None):
        return train_step(self.state, batch, self.generator, targets,
                          self.sampling_generator, self.reduce)

    @span("l2s.graph_capture")
    def _capture(self, batch: Dict[str, torch.Tensor]) -> None:
        gens = [g for g in (self.generator, self.sampling_generator)
                if g is not None]
        if any(g.device.type != "cuda" for g in gens):
            raise ValueError("a graphed step draws from CUDA generators only")
        self._static = {k: v.clone() for k, v in batch.items()}
        t0 = time.perf_counter()
        torch.cuda.synchronize()

        def step():
            losses = _step_body(self.state, self._static, self.generator,
                                None, self.sampling_generator, self.reduce)
            self._keys = sorted(losses)
            return torch.stack([losses[k] for k in self._keys])
        graph, self._loss_vec, self.record = capture_graph(
            step, generators=gens)
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.graph = graph

    @span("l2s.graph_replay")
    def _replay(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if set(batch) != set(self._static):
            raise ValueError(f"graphed step: batch entries {sorted(batch)} "
                             f"differ from the captured {sorted(self._static)}")
        for k, buf in self._static.items():
            v = batch[k]
            if v.shape != buf.shape or v.dtype != buf.dtype:
                raise ValueError(
                    f"graphed step: {k} is {tuple(v.shape)} {v.dtype}, the "
                    f"graph was captured at {tuple(buf.shape)} {buf.dtype}")
            buf.copy_(v)
        set_lr(self.state.optimizer, self.state.model.cfg, self.state.step)
        self.graph.replay()
        trace.add(self.record)
        self.state.step += 1
        return self._loss_vec

    def __call__(self, batches: Dict[str, torch.Tensor],
                 targets: Optional[Sequence[Tuple]] = None
                 ) -> Dict[str, torch.Tensor]:
        k = next(iter(batches.values())).shape[0]
        items = [{n: v[j] for n, v in batches.items()} for j in range(k)]
        if not self.graphed:
            per = [self._eager(b, None if targets is None else targets[j])
                   for j, b in enumerate(items)]
            return {n: torch.stack([p[n] for p in per]) for n in per[0]}
        if targets is not None:
            raise ValueError("a graphed step takes no injected targets")
        rows = []
        if self.graph is None:
            first = self._eager(items.pop(0))
            self._capture({n: v[0] for n, v in batches.items()})
            rows.append(torch.stack([first[n] for n in self._keys]))
        out = torch.empty((k, len(self._keys)), dtype=torch.float32,
                          device=self._loss_vec.device)
        if rows:
            out[0].copy_(rows[0])
        for j, b in enumerate(items, start=k - len(items)):
            out[j].copy_(self._replay(b))
        return {n: out[:, i] for i, n in enumerate(self._keys)}


def make_multi_train_step(state: TrainState, generator,
                          sampling_generator=None,
                          reduce: Optional[ReduceFn] = None) -> MultiStep:
    """K sequential SGD steps a call, the same steps as K `train_step`
    calls with the same generators (see `MultiStep`)."""
    return MultiStep(state, generator, sampling_generator, reduce)
