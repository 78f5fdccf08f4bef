"""MobileNetV1 backbone.

Counterpart of `lang2seg_tpu/models/mobilenet.py` (the reference's
`nets/mobilenet_v1.py`, present in its zoo but unused): a 3x3/2 stem conv
and 11 depthwise-separable blocks to stride 16 and 512 channels as the
head; two more stride-1 blocks to 1024 channels as the per-ROI tail on
7x7 crops. Each block is a 3x3 depthwise conv (groups = C), a frozen
BatchNorm and a ReLU, then a 1x1 conv, a frozen BatchNorm and a ReLU.

Parameter names are the JAX module's, under `mobilenet.`: `stem`,
`stem_bn`, `block{i}.dw`, `block{i}.dw_bn`, `block{i}.pw`,
`block{i}.pw_bn`, `tail{i}.*`. Neither the JAX package's
`engine/convert.py::convert_torch_state_dict` nor the reference's
lang2seg checkpoints hold MobileNet keys, so there are no reference
names to follow; `weights.from_jax_params` maps the JAX tree onto these.

Every BatchNorm is a `FrozenBatchNorm`: its statistics are buffers and
stay fixed. The JAX package's optimizer trains them (its frozen-name
test matches `bn*`, which `stem_bn`, `dw_bn` and `pw_bn` are not); the
port does not copy that (ROADMAP Queue 3). Every conv trains, as in the
JAX package. Convolutions run on NCHW `channels_last` tensors in the
compute dtype, their f32 parameters cast per call (`resnet.Conv2d`);
each BatchNorm and its ReLU are one `bn_act` call, as in the ResNet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.bn_act_cuda import bn_act
from .resnet import Conv2d, FrozenBatchNorm

# (depthwise stride, out channels) of each block after the stem
BLOCKS_HEAD = ((1, 64), (2, 128), (1, 128), (2, 256), (1, 256),
               (2, 512), (1, 512), (1, 512), (1, 512), (1, 512), (1, 512))
BLOCKS_TAIL = ((1, 1024), (1, 1024))     # stride 1, as a C4-style tail
HEAD_DIM = BLOCKS_HEAD[-1][1]
TAIL_DIM = BLOCKS_TAIL[-1][1]


class DWSep(nn.Module):
    """Depthwise 3x3 (stride on it) + BN + ReLU, pointwise 1x1 + BN +
    ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.dw = Conv2d(cin, cin, 3, stride=stride, padding=1, groups=cin,
                         bias=False)
        self.dw_bn = FrozenBatchNorm(cin)
        self.pw = Conv2d(cin, features, 1, bias=False)
        self.pw_bn = FrozenBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = bn_act(self.dw(x), self.dw_bn)
        return bn_act(self.pw(x), self.pw_bn)


class MobileNetV1(nn.Module):
    """`head(images)` -> (B, H/16, W/16, 512); `tail(crops)` -> (R, S, S,
    1024)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv2d(3, 32, 3, stride=2, padding=1, bias=False)
        self.stem_bn = FrozenBatchNorm(32)
        cin = 32
        for i, (s, f) in enumerate(BLOCKS_HEAD):
            self.add_module(f"block{i}", DWSep(cin, f, s))
            cin = f
        for i, (s, f) in enumerate(BLOCKS_TAIL):
            self.add_module(f"tail{i}", DWSep(cin, f, s))
            cin = f

    def head(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) f32 mean-subtracted BGR -> (B, H/16, W/16, 512)."""
        x = images.permute(0, 3, 1, 2).to(self.dtype,
                                          memory_format=torch.channels_last)
        x = bn_act(self.stem(x), self.stem_bn)
        for i in range(len(BLOCKS_HEAD)):
            x = getattr(self, f"block{i}")(x)
        return x.permute(0, 2, 3, 1)

    def tail(self, pool5: torch.Tensor) -> torch.Tensor:
        """(R, S, S, 512) crops (or whole maps) -> (R, S, S, 1024)."""
        x = pool5.permute(0, 3, 1, 2).to(self.dtype,
                                         memory_format=torch.channels_last)
        for i in range(len(BLOCKS_TAIL)):
            x = getattr(self, f"tail{i}")(x)
        return x.permute(0, 2, 3, 1)
