"""The data-parallel training step.

Counterpart of `lang2seg_tpu/parallel/train.py` (`shard_batch`,
`_pmean_flat`, `make_sharded_train_step`, `make_sharded_multi_step`).
Each rank holds the whole model and takes its own self-contained block of
the batch (`data/loader.py::get_batch(num_shards=n, shard=rank)`: the
block's `img_idx` index its own images); after the backward one flat
all-reduce a dtype averages the gradients and the losses, and every rank
applies the same update. Losses: the step optimises the mean over blocks
of each block's loss, as JAX's pmean does.

Randomness, as JAX folds it: dropout draws (word dropout, VGG16's fc6 and
fc7, the captioner) come from a generator of the rank's own, seeded from
(cfg.seed, rank); the batch carries `expr_uid`, so the anchor and ROI
priorities are per-example hashes under one per-step key drawn from a
sampling generator that every rank seeds alike (`ops/targets.py::
example_uniforms`): an example draws the same subsample on any rank.

Weights: each rank builds them from the same seed; `sync_replicas`
broadcasts rank 0's and each rank asserts its own are equal to them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..engine.optimizer import set_lr
from ..engine.train_state import (MultiStep, ReduceFn, TrainState,
                                  _clip_and_step, _forward_backward, _grads,
                                  make_multi_train_step, to_device,
                                  train_step)
from .mesh import Mesh


def shard_batch(batch: Dict, num_shards: int,
                rank: Optional[int] = None) -> Dict:
    """Check that a batch of `num_shards` blocks is shardable: every
    array's leading dim divides by num_shards, and each block's img_idx
    indexes its own image block ([0, images a block)). Returns the batch,
    or with `rank` its block `rank`."""
    for k, v in batch.items():
        if getattr(v, "ndim", 0) > 0 and v.shape[0] % num_shards:
            raise ValueError(f"{k} leading dim {v.shape[0]} not divisible "
                             f"by {num_shards}")
    if "img_idx" in batch and "images" in batch:
        per_img = batch["images"].shape[0] // num_shards
        idx = torch.as_tensor(batch["img_idx"]).reshape(num_shards, -1)
        if not bool(((idx >= 0) & (idx < per_img)).all()):
            raise ValueError(
                f"img_idx must be local to each block's images "
                f"(0..{per_img - 1}); got per-block ranges "
                f"{[(int(r.min()), int(r.max())) for r in idx]}")
    if rank is None:
        return batch
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) > 0:
            per = v.shape[0] // num_shards
            v = v[rank * per:(rank + 1) * per]
        out[k] = v
    return out


def _pmean_flat(tensors: Sequence[torch.Tensor], mesh: Mesh
                ) -> List[torch.Tensor]:
    """The mean over ranks of each tensor, in place: one all-reduce (sum)
    of one concatenated buffer a dtype, then the division by the world
    size, as JAX's `_pmean_flat` (`pmean` = psum / n). Concatenation moves
    neither the values nor the per-element order of the additions."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idxs in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)
        off = 0
        for i in idxs:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
    return list(tensors)


def pmean_hook(mesh: Mesh) -> ReduceFn:
    """The step's reduction: gradients averaged in place, losses averaged
    (one all-reduce a dtype each)."""
    def reduce(grads, losses):
        _pmean_flat(grads, mesh)
        keys = sorted(losses)
        vec = torch.stack([losses[k] for k in keys])
        _pmean_flat([vec], mesh)
        return dict(zip(keys, vec.unbind(0)))
    return reduce


def dropout_generator(seed: int, rank: int, device) -> torch.Generator:
    """The rank's dropout generator, seeded from (seed, rank)."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & 0xFFFFFFFF) << 32) | rank)
    return g


def sampling_generator(seed: int, device) -> torch.Generator:
    """The sampling key's generator, seeded alike on every rank."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & 0xFFFFFFFF) << 32) | 0xFFFFFFFF)
    return g


@torch.no_grad()
def sync_replicas(model: torch.nn.Module, mesh: Mesh) -> None:
    """Broadcast rank 0's weights and buffers (one broadcast a dtype) and
    raise on a rank whose own differ from them, naming the entries."""
    by_dtype: Dict[torch.dtype, List] = {}
    for name, t in model.state_dict().items():
        by_dtype.setdefault(t.dtype, []).append((name, t))
    for dtype, entries in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        flat = torch.cat([t.reshape(-1) for _, t in entries])
        wire = flat.view(torch.uint8) if dtype == torch.bool else flat
        ref = wire.clone()
        dist.broadcast(ref, 0, group=mesh.group)
        if not torch.equal(ref, wire):
            off, differ = 0, []
            for name, t in entries:
                n = t.numel()
                if not torch.equal(ref[off:off + n], wire[off:off + n]):
                    differ.append(name)
                off += n
            raise RuntimeError(
                f"data parallel: rank {mesh.rank}'s {dtype} weights differ "
                f"from rank 0's in {differ[:8]} ({len(differ)} entries; "
                f"build every rank from the same seed)")


def make_sharded_train_step(state: TrainState, mesh: Mesh,
                            generator: torch.Generator,
                            sampling_gen: torch.Generator):
    """step(block, targets=None) -> the losses averaged over ranks: this
    rank's forward and backward on its block, the gradients and losses
    averaged over ranks, the same update on every rank."""
    reduce = pmean_hook(mesh)

    def step(block: Dict[str, torch.Tensor], targets=None):
        return train_step(state, block, generator, targets, sampling_gen,
                          reduce)
    return step


def make_sharded_multi_step(state: TrainState, mesh: Mesh,
                            generator: torch.Generator,
                            sampling_gen: torch.Generator) -> MultiStep:
    """K data-parallel steps a call (`engine/train_state.py::MultiStep`):
    on the card the step is a CUDA graph with the NCCL all-reduce captured
    in it; on the CPU the call takes K eager sharded steps over gloo. gloo
    cannot be captured, so a gloo mesh on the card raises (its ranks take
    single sharded steps)."""
    if next(state.model.parameters()).device.type == "cuda" and \
            mesh.backend != "nccl":
        raise ValueError(f"a graphed data-parallel step needs NCCL, not "
                         f"{mesh.backend}")
    return make_multi_train_step(state, generator, sampling_gen,
                                 pmean_hook(mesh))


def shardwise_step(state: TrainState, batch: Dict, generators,
                   sampling_gen: Optional[torch.Generator],
                   targets: Optional[Sequence] = None
                   ) -> Dict[str, torch.Tensor]:
    """The one-process oracle of a data-parallel step over `batch`'s
    len(generators) blocks (tests/test_parallel.py's shardwise oracle):
    each block's losses and gradients in turn, block r with generators[r]
    (rank r's dropout generator) and every block with the same sampling
    key, summed and divided by the block count as the all-reduce does,
    then one update. Equal bit for bit to the ranks' step where the sum of
    two values does not depend on their order, i.e. for two ranks."""
    n = len(generators)
    device = next(state.model.parameters()).device
    start = sampling_gen.get_state() if sampling_gen is not None else None
    grad_sum = loss_sum = keys = None
    for r in range(n):
        if sampling_gen is not None:
            sampling_gen.set_state(start)
        losses = _forward_backward(
            state, to_device(shard_batch(batch, n, r), device), generators[r],
            None if targets is None else targets[r], sampling_gen)
        grads = [g.clone() for g in _grads(state)]
        keys = sorted(losses)
        vec = torch.stack([losses[k] for k in keys])
        if grad_sum is None:
            grad_sum, loss_sum = grads, vec
        else:
            grad_sum = [a + b for a, b in zip(grad_sum, grads)]
            loss_sum = loss_sum + vec
    grads = _grads(state)
    for g, total in zip(grads, grad_sum):
        g.copy_(total / n)
    set_lr(state.optimizer, state.model.cfg, state.step)
    _clip_and_step(state, grads)
    state.step += 1
    return dict(zip(keys, (loss_sum / n).unbind(0)))
