"""VGG16 backbone of the detection-only `vgg` variant.

Counterpart of `lang2seg_tpu/models/vgg.py` and of the reference's
`nets/vgg16.py:43-89`: the head is torchvision's vgg16 `features` without
its last max-pool (conv5_3 + ReLU, 512 channels, stride 16); the tail
flattens a 7x7 crop and runs fc6 (4096) + ReLU + dropout, fc7 (4096) +
ReLU + dropout, returned as (R, 1, 1, 4096) so that the box head's
spatial mean is the identity. Parameter names are the reference's:
`features.{0,2,5,7,10,12,14,17,19,21,24,26,28}` for conv1_1 .. conv5_3 and
`classifier.{0,3}` for fc6 and fc7 (torchvision's `classifier.6` is not
part of the network).

The tail flattens the crop channel-major, (C, 7, 7), as the reference's
fc6 reads it; the JAX package flattens (7, 7, C) and permutes fc6's input
rows on conversion (`weights.from_jax_params` undoes that). Convolutions
run on NCHW `channels_last` tensors in the compute dtype, their f32
parameters cast per call; fc6 and fc7 run in f32, as the JAX package
casts the crop (`vgg.py:57`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .lang_encoder import word_dropout
from .resnet import Conv2d

# (convs, channels) of conv1 .. conv5; a 2x2 max-pool follows each but conv5
STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# `features` indices of conv1_* and conv2_*, which the reference freezes
# (its first 10 feature layers, nets/vgg16.py:48-50)
FROZEN_FEATURES = (0, 2, 5, 7)


class VGG16(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 drop_rate: float = 0.5):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        layers, cin = [], 3
        for si, (n, ch) in enumerate(STAGES):
            for _ in range(n):
                layers += [Conv2d(cin, ch, 3, padding=1), nn.ReLU(inplace=True)]
                cin = ch
            if si < len(STAGES) - 1:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(inplace=True),
            nn.Dropout(drop_rate), nn.Linear(4096, 4096),
            nn.ReLU(inplace=True), nn.Dropout(drop_rate))

    def freeze(self) -> None:
        """requires_grad=False on conv1_* and conv2_* (the JAX package's
        optimizer mask, `engine/optimizer.py::_is_frozen`)."""
        for idx in FROZEN_FEATURES:
            for p in self.features[idx].parameters():
                p.requires_grad_(False)

    def head(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) f32 mean-subtracted BGR -> (B, H/16, W/16, 512)."""
        x = images.permute(0, 3, 1, 2).to(self.dtype,
                                          memory_format=torch.channels_last)
        return self.features(x).permute(0, 2, 3, 1)

    def tail(self, pool5: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(R, 7, 7, 512) crops -> (R, 1, 1, 4096) f32. In train mode with
        a dropout rate above 0, `generator` draws fc6's dropout mask, then
        fc7's (required)."""
        r = pool5.shape[0]
        flat = pool5.permute(0, 3, 1, 2).reshape(r, -1).float()
        drop = self.training and self.drop_rate > 0.0
        if drop and generator is None:
            raise ValueError("VGG16.tail: dropout in train mode needs a "
                             "torch.Generator")
        x = flat
        for fc in (self.classifier[0], self.classifier[3]):
            x = F.relu(fc(x))
            if drop:
                x = word_dropout(x, self.drop_rate, generator)
        return x.reshape(r, 1, 1, 4096)
