"""The ResNet-C4 head replayed as a CUDA graph (`models/resnet.py::
ResNetC4.head`) against its eager pass on the card, in the flagship
`response` model (ResNet-101 to layer3, bf16, random weights), at the
serving shape (1 image of 640 x 1024) and the eval shape (4 images a
dispatch).

    python -m lang2seg_tpu_torch.tools.profile_head [--reps 20]

For each shape: the first graphed call (it captures) and a replay
against the eager pass, bit for bit; the host's ms a call (back-to-back
calls, no sync between them: the host's enqueue time where the card keeps
up); from a torch.profiler trace of one call, the runtime calls that put
work on the device and the device's busy ms (`profile_eval.
device_busy`); the first call's seconds and the bytes of the graphs'
memory pool after it. Prints one JSON line a shape. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import re
import time
from typing import Dict, Tuple

import torch

from ..config import flagship_config
from ..models import resnet
from ..models.network import build_model
from .profile_bn_act import same_bits
from .profile_eval import device_busy

# the serving request's and the eval dispatch's images
SHAPES = (("serve", 1), ("eval", 4))
# runtime calls that put work on the device (benchmark/spans.py's)
RUNTIME = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                     r"GraphLaunch|Memcpy|Memset)")


def traced(fn) -> Tuple[int, float]:
    """One fn() call under torch.profiler: (the runtime calls that put work
    on the device, the device's busy ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return (sum(1 for e in prof.events() if RUNTIME.match(e.name)),
            device_busy(prof)["busy_ms"])


def host_ms(fn, reps: int) -> float:
    """Host ms a call over `reps` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def pool_bytes(pool) -> int:
    """Bytes of the device segments in the memory pool `pool`."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def compare(net: resnet.ResNetC4, n: int, dev, reps: int = 20,
            seed: int = 0) -> Dict:
    """The graphed head against the eager pass on n mean-subtracted
    640 x 1024 images drawn from `seed`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, 640, 1024, 3), generator=g, device=dev) * 60
    with torch.no_grad():
        eager = net._head(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = net.head(x)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        replay = net.head(x)
        res = {"images": n,
               "bits_equal": same_bits(first, eager)
               and same_bits(replay, eager)
               and first.stride() == eager.stride(),
               "first_call_s": first_s,
               "pool_bytes": pool_bytes(resnet._GRAPHS[net].pool)}
        for name, fn in (("eager", lambda: net._head(x)),
                         ("graphed", lambda: net.head(x))):
            res[f"{name}_host_ms"] = host_ms(fn, reps)
            res[f"{name}_runtime_calls"], res[f"{name}_device_ms"] = \
                traced(fn)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_head: needs a CUDA device")
    dev = torch.device("cuda")
    net = build_model(flagship_config(), device=dev, seed=0).backbone
    for name, n in SHAPES:
        print(json.dumps({"shape": name, **compare(net, n, dev, args.reps)}),
              flush=True)


if __name__ == "__main__":
    main()
