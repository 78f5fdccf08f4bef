"""The process group of data-parallel training and evaluation.

Counterpart of `lang2seg_tpu/parallel/mesh.py`. JAX runs one program over
a 1-D device mesh; here each rank is a process with one device, joined by
a `torch.distributed` process group (NCCL on the card, gloo on the CPU).
`Mesh` is what a rank needs of it: the group, its rank, the world size
and its device. `initialize_multihost` is the counterpart of
`jax.distributed.initialize`: `init_process_group` from torchrun's
environment or from explicit arguments.

JAX's `batch_spec` and `replicate_spec` have no counterpart: a rank holds
the whole model (replicated by construction, `train.sync_replicas`) and
only its own block of each batch (`data/loader.py::get_batch(num_shards=n,
shard=rank)`), so there is nothing to annotate.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass
class Mesh:
    group: Optional[object]      # the process group (None: the default)
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         device="cuda", backend: Optional[str] = None,
                         timeout_s: Optional[float] = None) -> Mesh:
    """Join the process group and return this rank's `Mesh`. Without
    arguments the address, world size and rank come from torchrun's
    environment (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK);
    else pass all three (`tcp://localhost:<port>` or `file://<path>`).
    `device` "cuda" takes card LOCAL_RANK (raises without a card) and
    NCCL, "cpu" gloo; `backend` overrides the choice (gloo on the card is
    the one-card test configuration: NCCL refuses two ranks on one
    card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        kwargs["device_id"] = dev
    if init_method is None:
        if world_size is not None or rank is not None:
            raise ValueError("pass init_method with world_size and rank")
        init_method = "env://"
    elif world_size is None or rank is None:
        raise ValueError(f"init_method {init_method!r} needs world_size and "
                         "rank")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)
    return make_mesh(device=dev)


def make_mesh(num_data: Optional[int] = None, device=None) -> Mesh:
    """This rank's view of the initialised process group. `num_data`,
    when given, must be the world size; `device` defaults to card
    LOCAL_RANK on NCCL and the CPU on gloo. Raises when no process group
    is initialised: a data-parallel run never goes on alone."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "data parallel: no torch.distributed process group; call "
            "parallel.initialize_multihost (or run under torchrun) first")
    size = dist.get_world_size()
    if num_data is not None and num_data != size:
        raise ValueError(f"data parallel: num_data {num_data} but the "
                         f"process group has {size} ranks")
    if device is None:
        device = (torch.device("cuda", _local_rank())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(None, dist.get_rank(), size, torch.device(device))
