"""The frozen-BatchNorm kernels (`csrc/bn_act.cu`) on the card, at the
main path's shapes.

    python -m lang2seg_tpu_torch.tools.profile_bn_act [--reps 20]

Shapes (`SHAPES`): layer4 on the serving crops (16 x 300 = 4,800 of 7 x
7) and on the training crops (16 x 256 = 4,096): bn1 / bn2 + ReLU at C =
512, bn3 + residual + ReLU and bn3 + the downsample branch's BatchNorm +
ReLU at C = 2048; the backbone of one 640 x 1024 image (the stem, the
last BatchNorm of a layer1, layer2 and layer3 block, a layer3 bn1) and
of the training step's two images (layer3's last, forward and
backward). All bf16, the statistics drawn with both signs of scale. For
each shape: the forward kernel's output and, for a training shape, the
backward kernel's gradients against the plain composition under
autograd (`bn_act_plain`), bit for bit (signed zeros too); then each is
timed (`profile_nms.device_ms`) beside its bound (`traffic_bytes` /
3.35 TB/s) and the plain version (the composition forward under no_grad;
its autograd backward). No single PyTorch call computes the same
function. Prints one JSON line a shape, then the host's cost of a call
(`host_us`). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Dict

import torch

from ..models import resnet
from ..models.resnet import FrozenBatchNorm
from ..ops import bn_act_cuda
from .profile_nms import HBM_BYTES_PER_S, device_ms

MODES = {"relu": 0, "residual": 1, "down": 2}
# (name, N, C, H, W, variant, backward timed too)
SHAPES = (
    ("serve.layer4.bn12", 4800, 512, 7, 7, "relu", False),
    ("serve.layer4.bn3_res", 4800, 2048, 7, 7, "residual", False),
    ("serve.layer4.bn3_down", 4800, 2048, 7, 7, "down", False),
    ("train.layer4.bn12", 4096, 512, 7, 7, "relu", True),
    ("train.layer4.bn3_res", 4096, 2048, 7, 7, "residual", True),
    ("train.layer4.bn3_down", 4096, 2048, 7, 7, "down", True),
    ("serve.stem", 1, 64, 320, 512, "relu", False),
    ("serve.layer1.bn3_res", 1, 256, 160, 256, "residual", False),
    ("serve.layer2.bn3_res", 1, 512, 80, 128, "residual", False),
    ("serve.layer3.bn12", 1, 256, 40, 64, "relu", False),
    ("serve.layer3.bn3_res", 1, 1024, 40, 64, "residual", False),
    ("train.layer3.bn3_res", 2, 1024, 40, 64, "residual", True),
)


def traffic_bytes(n: int, c: int, h: int, w: int, elem: int, variant: str,
                  backward: bool = False) -> int:
    """Bytes a pass must move, each map read or written once: forward x
    (and the residual or x_d) in, the output out; backward g and the
    output in, x's gradient (and the residual's or x_d's) out."""
    maps = 2 + int(variant != "relu") + int(backward)
    return maps * n * c * h * w * elem


def bound_ms(byts: int) -> float:
    return byts / HBM_BYTES_PER_S * 1e3


def random_bn(c: int, g: torch.Generator, dev) -> FrozenBatchNorm:
    """Statistics of both signs of scale, var from 0.05 to 3."""
    bn = FrozenBatchNorm(c)
    bn.weight.copy_(torch.randn(c, generator=g) * 1.5)
    bn.bias.copy_(torch.randn(c, generator=g))
    bn.running_mean.copy_(torch.randn(c, generator=g) * 2)
    bn.running_var.copy_(torch.rand(c, generator=g) * 2.95 + 0.05)
    return bn.to(dev)


def inputs(n, c, h, w, dev, dtype=torch.bfloat16, seed=0):
    """x, the residual / x_d and the output's gradient (channels_last),
    and two FrozenBatchNorms."""
    g = torch.Generator(device=dev).manual_seed(seed)
    acts = [(torch.randn((n, h, w, c), generator=g, device=dev) * 3)
            .to(dtype).permute(0, 3, 1, 2) for _ in range(3)]
    gc = torch.Generator().manual_seed(seed)
    return acts, (random_bn(c, gc, dev), random_bn(c, gc, dev))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


def same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(_bits(a), _bits(b))


def _apply(op, variant, x, other, bn, bn_d):
    """op(x, bn) with the residual or the downsample branch of `variant`."""
    kw = {"relu": {}, "residual": {"residual": other},
          "down": {"down": (other, bn_d)}}[variant]
    return op(x, bn, **kw)


def check_shape(name, n, c, h, w, variant, backward, dev, reps=20,
                seed=0) -> Dict:
    """One shape: the kernels against the plain composition bit for bit,
    then timed beside their bounds and the plain version's time."""
    (x, other, up), (bn, bn_d) = inputs(n, c, h, w, dev, seed=seed)
    mode = MODES[variant]
    other_k = None if mode == 0 else other
    bn_d_k = bn_d if mode == 2 else None
    elem = x.element_size()
    res = {"name": name, "shape": [n, c, h, w], "variant": variant,
           "dtype": str(x.dtype).split(".")[-1]}
    got, graphs = [], []
    for op in (bn_act_cuda.bn_act, bn_act_cuda.bn_act_plain):
        xs = [t.clone().requires_grad_(True)
              for t in (x, other)[:1 + int(mode > 0)]]
        out = _apply(op, variant, xs[0], xs[-1], bn, bn_d)
        grads = torch.autograd.grad(out, xs, up, retain_graph=True)
        got.append([out.detach(), *grads])
        graphs.append((out, xs))
    res["forward_equal"] = same_bits(got[0][0], got[1][0])
    res["backward_equal"] = all(map(same_bits, got[0][1:], got[1][1:]))
    del got
    with torch.no_grad():
        res["ms"] = device_ms(lambda: bn_act_cuda.launch_forward(
            x, bn, other_k, bn_d_k), reps)
        res["plain_ms"] = device_ms(lambda: _apply(
            bn_act_cuda.bn_act_plain, variant, x, other, bn, bn_d), reps)
    res["bound_ms"] = bound_ms(traffic_bytes(n, c, h, w, elem, variant))
    res["share"] = res["bound_ms"] / res["ms"]
    if backward:
        out = graphs[0][0].detach()
        res["bwd_ms"] = device_ms(lambda: bn_act_cuda.launch_backward(
            up, out, bn, bn_d_k, mode), reps)
        plain, xs = graphs[1]
        res["bwd_plain_ms"] = device_ms(lambda: torch.autograd.grad(
            plain, xs, up, retain_graph=True), reps)
        res["bwd_bound_ms"] = bound_ms(traffic_bytes(n, c, h, w, elem,
                                                     variant, True))
        res["bwd_share"] = res["bwd_bound_ms"] / res["bwd_ms"]
    del graphs, x, other, up
    torch.cuda.empty_cache()
    return res


def host_us(dev, reps=2000) -> Dict[str, float]:
    """Host microseconds a call of a bottleneck's last BatchNorm (residual
    and ReLU) on a small map, (2, 256, 10, 10) bf16 under no_grad: the
    kernel's wrapper and the composition it replaces. The card runs either
    faster than the host enqueues it, so this is the host's cost."""
    (x, other, _), (bn, _) = inputs(2, 256, 10, 10, dev)
    res = {}
    with torch.no_grad():
        for name, fn in (("bn_act", bn_act_cuda.bn_act),
                         ("plain", bn_act_cuda.bn_act_plain)):
            for _ in range(20):
                fn(x, bn, residual=other)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(x, bn, residual=other)
            res[name] = (time.perf_counter() - t0) / reps * 1e6
            torch.cuda.synchronize()
    return res


@contextlib.contextmanager
def unfused():
    """The ResNet's BatchNorms run as the plain composition (the ops the
    bottleneck ran before `bn_act`), on any device, while inside."""
    fused = resnet.bn_act
    resnet.bn_act = bn_act_cuda.bn_act_plain
    try:
        yield
    finally:
        resnet.bn_act = fused


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_bn_act: needs a CUDA device")
    dev = torch.device("cuda")
    for shape in SHAPES:
        print(json.dumps(check_shape(*shape, dev, reps=args.reps)),
              flush=True)
    print(json.dumps({"host_us": host_us(dev)}), flush=True)


if __name__ == "__main__":
    main()
