"""The conditioning with its language half replayed as a CUDA graph
(`models/network.py::Lang2Seg._filters`) against the eager pass on the
card, in the flagship `response` model (bi-LSTM 2 x 512, 7 filters, the
sigmoid gate at C = 1024, random weights), at the serving shape (16
expressions on one 40 x 64 map) and at each dispatch shape of the eval
mix (1, 2 or 4 images a dispatch, buckets 4 / 8 / 16).

    python -m lang2seg_tpu_torch.tools.profile_condition [--reps 20]

For each shape: the first graphed call (it captures) and a replay against
the eager pass, bit for bit (the filters, the response filters, the gated
map and the response); the host's ms a `_condition` call (back-to-back
calls, no sync between them: the host's enqueue time where the card keeps
up); from a torch.profiler trace of one call, the runtime calls that put
work on the device and the device's busy ms; the first call's seconds
and the bytes of the graphs' memory pool after it. Prints one JSON line a
shape. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from ..config import flagship_config
from ..models import network
from ..models.network import build_model
from .profile_bn_act import same_bits
from .profile_head import host_ms, pool_bytes, traced

# (name, maps, expressions a map): serving's one image of 16 expressions,
# then eval's dispatches of 1, 2 or 4 images of buckets 4 / 8 / 16 (one
# image of 16 is serving's shape)
SHAPES = (("serve", 1, 16),
          ("eval_1x4", 1, 4), ("eval_2x4", 2, 4), ("eval_4x4", 4, 4),
          ("eval_1x8", 1, 8), ("eval_2x8", 2, 8), ("eval_4x8", 4, 8),
          ("eval_2x16", 2, 16), ("eval_4x16", 4, 16))


def inputs(model: network.Lang2Seg, maps: int, per_map: int, dev,
           seed: int = 0):
    """(maps, 40, 64, C) bf16 maps and (maps * per_map, max_len) labels of
    0 to max_len words, drawn from `seed`."""
    m, t = model.cfg.model, model.cfg.data.max_len
    g = torch.Generator().manual_seed(seed)
    e = maps * per_map
    labels = torch.randint(1, m.vocab_size, (e, t), generator=g,
                           dtype=torch.int32)
    lengths = torch.randint(0, t + 1, (e,), generator=g)
    labels[torch.arange(t)[None, :] >= lengths[:, None]] = 0
    conv = torch.randn((maps, 40, 64, m.c4_feat_dim), generator=g)
    return conv.to(dev, torch.bfloat16), labels.to(dev)


def compare(model: network.Lang2Seg, maps: int, per_map: int, dev,
            reps: int = 20, seed: int = 0) -> Dict:
    """The graphed conditioning against the eager pass at one shape."""
    conv, labels = inputs(model, maps, per_map, dev, seed)

    def eager():
        filt, rfilt = model._language(labels)
        return (filt, rfilt) + model.filter_gen.gate_map(conv, filt, rfilt,
                                                         per_map)

    def graphed():
        filt, rfilt = model._filters(labels)
        return (filt, rfilt) + model.filter_gen.gate_map(conv, filt, rfilt,
                                                         per_map)

    with torch.no_grad():
        want = eager()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = graphed()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        replay = graphed()
        whole = model._condition(conv, labels, exprs_per_map=per_map)
        res = {"maps": maps, "exprs_per_map": per_map,
               "bits_equal": all(same_bits(a, b) for got in (first, replay)
                                 for a, b in zip(got, want))
               and same_bits(whole[0], want[2])
               and same_bits(whole[1], want[3]),
               "first_call_s": first_s,
               "pool_bytes": pool_bytes(network._LANGUAGE_GRAPHS[model].pool)}
        for name, fn in (
                ("eager", lambda: model.filter_gen.gate_map(
                    conv, *model._language(labels), per_map)),
                ("graphed", lambda: model._condition(
                    conv, labels, exprs_per_map=per_map))):
            res[f"{name}_host_ms"] = host_ms(fn, reps)
            res[f"{name}_runtime_calls"], res[f"{name}_device_ms"] = \
                traced(fn)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_condition: needs a CUDA device")
    dev = torch.device("cuda")
    model = build_model(flagship_config(), device=dev, seed=0)
    for name, maps, per_map in SHAPES:
        print(json.dumps({"shape": name, **compare(model, maps, per_map, dev,
                                                    args.reps)}), flush=True)


if __name__ == "__main__":
    main()
