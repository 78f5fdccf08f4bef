"""ResNet-C4 backbone with frozen BatchNorm.

Counterpart of `lang2seg_tpu/models/resnet.py` (plain path only) and of
the reference's torchvision-style ResNet (`nets/resnet_v1.py:75-190`):
caffe-style bottleneck (stride on the first 1x1 conv), 3x3/2/1 max pool
after conv1, layer4 at stride 1 applied as the per-ROI tail on 7x7
crops. Every BatchNorm is frozen, so it is a constant per-channel affine
held in buffers; `freeze` takes the stem and the first stages out of
training, as the JAX package's optimizer does (`engine/optimizer.py::
_is_frozen`).
Parameter names are the reference's (`conv1`, `bn1`, `layer3.4.conv2`,
`layer1.0.downsample.0`, ...).

Public methods take and return NHWC tensors; inside, activations are
NCHW tensors in `torch.channels_last` memory format (the same bytes as
NHWC), and convolutions run in the input's dtype with their f32
parameters cast per call, as flax's `nn.Conv(dtype=...)` does; gradients
flow through the casts to the f32 parameters.

Every frozen BatchNorm is applied by `ops/bn_act_cuda.py::bn_act`
together with what follows it: the ReLU, and in a block's last one the
residual or the downsample branch's own BatchNorm, one kernel launch on
the card (its plain version, the same ops as `FrozenBatchNorm` then
`+ residual` then `F.relu`, on the CPU).

On the card with no gradient recorded (serving, eval, validation), `head`
replays its pass as a CUDA graph, one for each input shape (`_Graphs`):
the host enqueues a copy in, one graph launch and a copy out in place of
the ~290 calls of the eager pass (the weights' casts, the convolutions,
the `bn_act` launches). A replay runs the same kernels on the same
addresses, so it gives the eager pass's bits and reads the parameters and
buffers as they are then: an in-place update (SGD, `load_state_dict`'s
copy) is seen; a parameter or buffer re-bound to other storage (`.to()`,
`load_state_dict(assign=True)`) drops the graphs, and the next call
captures again. Calls that record a gradient (training) and calls on the
CPU run eager.
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F
from torch import nn

from ..device import GraphedPasses
from ..ops.bn_act_cuda import bn_act

STAGE_BLOCKS = {
    "resnet26": (1, 1, 1, 1),   # test-only tiny depth
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the input's dtype: f32 parameters are cast
    to it per call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, w, b)


class FrozenBatchNorm(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * weight + bias with fixed
    statistics, applied as x * inv + offset in x's dtype. The four
    tensors are buffers under the reference's BatchNorm2d names."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NCHW
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        offset = self.bias - self.running_mean * inv
        return (x * inv.to(x.dtype)[:, None, None]
                + offset.to(x.dtype)[:, None, None])


class Bottleneck(nn.Module):
    """Caffe-style bottleneck: the stride sits on conv1 (reference
    resnet_v1.py:80)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = (nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            FrozenBatchNorm(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = bn_act(self.conv1(x), self.bn1)
        out = bn_act(self.conv2(out), self.bn2)
        out = self.conv3(out)
        if self.downsample is None:
            return bn_act(out, self.bn3, residual=x)
        # the downsample conv runs last: its map lives only beside conv3's
        conv, bn = self.downsample
        return bn_act(out, self.bn3, down=(conv(x), bn))


def _stage(inplanes: int, planes: int, blocks: int, stride: int):
    layers = [Bottleneck(inplanes, planes, stride, downsample=True)]
    layers += [Bottleneck(planes * 4, planes) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


# the most input keys (shape, dtype, device) a ResNetC4 keeps a captured
# head for; past it, calls run eager
GRAPH_KEYS = 4


class _Graphs(GraphedPasses):
    """A ResNetC4's captured heads by input key (`device.GraphedPasses`),
    and what they read: the BatchNorm pass, the compute dtype and the
    address of every parameter and buffer of conv1 .. layer3."""

    def __init__(self, net: "ResNetC4"):
        super().__init__([net.conv1, net.bn1, net.layer1, net.layer2,
                          net.layer3], "backbone")

    def reads_now(self, net: "ResNetC4") -> tuple:
        """What a replay must find unchanged (~50 us on the host for
        ResNet-101's 470 tensors)."""
        return (bn_act, net.dtype, self.addresses())


# a ResNetC4 -> its `_Graphs` (kept off the module: a deep copy or a
# pickle of the model carries no graph)
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class ResNetC4(nn.Module):
    """`head(images)` = conv1..layer3 (stride 16, 1024 channels);
    `tail(crops)` = layer4 at stride 1 (reference resnet_v1.py:255-267)."""

    def __init__(self, depth: str = "resnet101",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        b = STAGE_BLOCKS[depth]
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = _stage(64, 64, b[0], 1)
        self.layer2 = _stage(256, 128, b[1], 2)
        self.layer3 = _stage(512, 256, b[2], 2)
        self.layer4 = _stage(1024, 512, b[3], 1)

    def freeze(self, fixed_blocks: int) -> None:
        """requires_grad=False on the stem conv1 and on layer1 ..
        layer{fixed_blocks} (the reference's frozen set, cfg.RESNET.
        FIXED_BLOCKS; the BatchNorms are buffers already)."""
        frozen = [self.conv1] + [getattr(self, f"layer{i}")
                                 for i in range(1, fixed_blocks + 1)]
        for mod in frozen:
            for p in mod.parameters():
                p.requires_grad_(False)

    def head(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) f32 mean-subtracted BGR -> (B, H/16, W/16, 1024);
        a CUDA graph's replay for a CUDA input with no gradient recorded
        (module docstring), a fresh tensor either way."""
        if images.is_cuda and not torch.is_grad_enabled():
            return self._graphed_head(images)
        return self._head(images)

    def _head(self, images: torch.Tensor) -> torch.Tensor:
        """The eager pass of `head`."""
        x = images.permute(0, 3, 1, 2).to(self.dtype,
                                          memory_format=torch.channels_last)
        x = bn_act(self.conv1(x), self.bn1)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer3(self.layer2(self.layer1(x)))
        return x.permute(0, 2, 3, 1)

    def _graphed_head(self, images: torch.Tensor) -> torch.Tensor:
        """The head by the graph captured at the images' (shape, dtype,
        device), capturing it first if need be (`GraphedPasses.run`): a
        copy of its output, so an earlier call's result is never
        overwritten. Counts `backbone.graph_replays` and the captured
        pass's launches, or `backbone.graph_eager` past `GRAPH_KEYS`
        keys."""
        g = _GRAPHS.get(self)
        if g is None:
            g = _GRAPHS[self] = _Graphs(self)
        return g.run(self._head, (images,), g.reads_now(self), GRAPH_KEYS)

    def tail(self, pool5: torch.Tensor) -> torch.Tensor:
        """(R, S, S, 1024) -> spatial_fc7 (R, S, S, 2048)."""
        x = pool5.permute(0, 3, 1, 2).to(self.dtype,
                                         memory_format=torch.channels_last)
        return self.layer4(x).permute(0, 2, 3, 1)
