"""RPN, box and mask heads.

Counterpart of `lang2seg_tpu/models/heads.py` (reference
`nets/network.py:232-304`, modules `nets/resnet_v1.py:310-321`). Layers
carry the reference's names (`rpn_net`, `rpn_cls_score_net`,
`rpn_bbox_pred_net`, `cls_score_net`, `bbox_pred_net`,
`mask_up_sampling`, `mask_pred_net`) and layouts; outputs keep the JAX
package's: RPN (..., A, 2) / (..., A, 4) in the (H, W, A) anchor order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d


class RPNHead(nn.Module):
    """3x3 conv (C4 -> 512) + ReLU, then 1x1 cls (2A) and bbox (4A), in
    the compute dtype; logits and deltas return as f32."""

    def __init__(self, in_channels: int = 1024, num_anchors: int = 12,
                 mid_channels: int = 512):
        super().__init__()
        self.num_anchors = num_anchors
        self.rpn_net = Conv2d(in_channels, mid_channels, 3, padding=1)
        self.rpn_cls_score_net = Conv2d(mid_channels, 2 * num_anchors, 1)
        self.rpn_bbox_pred_net = Conv2d(mid_channels, 4 * num_anchors, 1)

    def forward(self, net_conv: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """net_conv (E, H, W, C) -> cls (E, H, W, A, 2), box (E, H, W, A, 4)."""
        a = self.num_anchors
        x = net_conv.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        rpn = F.relu(self.rpn_net(x))
        cls = self.rpn_cls_score_net(rpn).float()
        box = self.rpn_bbox_pred_net(rpn).float()
        e, _, h, w = cls.shape
        # reference channel order: cls channel = c * A + a, bbox = a * 4 + d
        cls = cls.reshape(e, 2, a, h, w).permute(0, 3, 4, 2, 1)
        box = box.reshape(e, a, 4, h, w).permute(0, 3, 4, 1, 2)
        return cls, box


class BoxHead(nn.Module):
    """Mean-pool spatial_fc7 -> class scores + per-class box deltas
    (network.py:274-287)."""

    def __init__(self, in_features: int = 2048, num_classes: int = 81):
        super().__init__()
        self.cls_score_net = nn.Linear(in_features, num_classes)
        self.bbox_pred_net = nn.Linear(in_features, num_classes * 4)

    def forward(self, spatial_fc7: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R, S, S, D) -> (cls_score (R, K), bbox_pred (R, 4K))."""
        fc7 = spatial_fc7.float().mean(dim=(1, 2))
        return self.cls_score_net(fc7), self.bbox_pred_net(fc7)


class MaskHead(nn.Module):
    """ConvTranspose 2x2/2 -> 256 + ReLU -> 1x1 conv -> per-class mask
    logits at 14x14 (network.py:289-304), in f32.

    The stride-2 2x2 deconv has no overlapping taps, so it runs as a 1x1
    matmul to 4x256 channels plus depth-to-space (the JAX package's
    `_Upsample2x`). Only each row's labelled class is computed
    (`_ClassConv1x1`'s selected-class path, the one both callers of the
    reference use): its kernel column and bias are taken by a one-hot
    product, exact in the forward (f32, TF32 off as the port runs), whose
    gradient sums each class's rows in a fixed order (CUDA's index_select
    backward adds them with atomics in an order that changes from run to
    run, and a graphed step must replay the eager step's bits)."""

    def __init__(self, in_features: int = 2048, num_classes: int = 81,
                 features: int = 256):
        super().__init__()
        self.mask_up_sampling = nn.ConvTranspose2d(in_features, features, 2,
                                                   stride=2)
        self.mask_pred_net = nn.Conv2d(features, num_classes, 1)

    def forward(self, spatial_fc7: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        """(R, S, S, D) features, (R,) class ids -> (R, 2S, 2S) logits of
        each row's class."""
        x = spatial_fc7.float()
        r, h, w, c = x.shape
        wt = self.mask_up_sampling.weight                   # (C, F, 2, 2)
        f = wt.shape[1]
        # out[r, 2h+i, 2w+j, f] = sum_c x[r, h, w, c] * wt[c, f, i, j]
        y = torch.matmul(x.reshape(-1, c), wt.reshape(c, f * 4))
        y = y.reshape(r, h, w, f, 2, 2).permute(0, 1, 4, 2, 5, 3)
        y = F.relu(y.reshape(r, 2 * h, 2 * w, f) + self.mask_up_sampling.bias)
        classes = torch.arange(self.mask_pred_net.out_channels,
                               device=labels.device)
        onehot = (labels.long()[:, None] == classes).to(y.dtype)
        kcol = onehot @ self.mask_pred_net.weight[:, :, 0, 0]
        bcol = onehot @ self.mask_pred_net.bias
        return torch.einsum("rhwf,rf->rhw", y, kcol) + bcol[:, None, None]
