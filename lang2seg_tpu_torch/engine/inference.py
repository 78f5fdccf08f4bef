"""Inference / feature-extraction service.

Counterpart of `lang2seg_tpu/engine/inference.py::Inference` (reference
mrcn wrappers `lib/mrcn/inference.py:46-345`): `extract_head` (C4
features), `predict` (test-mode forward), `boxes_to_masks` (mask probs
for given boxes and labels), `box_to_spatial_fc7` (pooled ROI features),
`head_to_prediction` (scores and deltas for ROI features). A
detection-only model (the `vgg` variant) serves everything but
`boxes_to_masks`.

Inputs may be numpy arrays or tensors; outputs are tensors on the
service's device (the gated map stays there for `boxes_to_masks`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models.network import Lang2Seg


class Inference:
    def __init__(self, model: Lang2Seg, cfg: Config, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg

    def _in(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    @torch.no_grad()
    def extract_head(self, images) -> torch.Tensor:
        """(B, H, W, 3) canvas -> (B, H/16, W/16, C) C4 features
        (reference extract_head, network.py:619)."""
        return self.model.backbone.head(self.model._images(self._in(images)))

    def predict(self, images, im_hw, labels) -> Dict[str, torch.Tensor]:
        """Full test-mode forward (reference mrcn predict)."""
        return self.model.test_forward({"images": self._in(images),
                                        "im_hw": self._in(im_hw),
                                        "labels": self._in(labels)})

    def boxes_to_masks(self, gated_conv, boxes, labels) -> torch.Tensor:
        """(E, B, 4) boxes + (E, B) class labels -> (E, B, S, S) mask
        probs (reference boxes_to_masks). Raises ValueError for a
        detection-only model (no mask head)."""
        return self.model.predict_masks(self._in(gated_conv),
                                        self._in(boxes).float(),
                                        self._in(labels))

    @torch.no_grad()
    def box_to_spatial_fc7(self, gated_conv, rois) -> torch.Tensor:
        """(E, R, 4) rois -> (E, R, 7, 7, 2048) pooled tail features, or
        (E, R, 1, 1, 4096) for VGG16 (reference box_to_spatial_fc7)."""
        return self.model._roi_features(self._in(gated_conv),
                                        self._in(rois).float())

    @torch.no_grad()
    def head_to_prediction(self, spatial_fc7
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(E, R, S, S, D) ROI features -> (scores (E*R, K), deltas
        (E*R, 4K)) (reference head_to_prediction)."""
        x = self._in(spatial_fc7)
        return self.model.box_head(x.reshape(-1, *x.shape[2:]))
