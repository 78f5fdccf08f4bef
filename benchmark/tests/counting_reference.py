"""A reference module for the tests of the harness's lookup: `model`'s
network and functions, with each construction of `Reference`, each of its
forwards and each call of `frozen_statistics` logged in `LOG` with the
device it ran on. The tests install it as `benchmark/reference/
counting.py` of a copy of the tree and name it from a configuration's
`"reference"`, so its relative imports are those of that directory."""

from __future__ import annotations

from typing import List, Tuple

# re-exported: the functions every reference module provides
from .model import (PlainSGD, crop_gather, namespace,  # noqa: F401
                    param_groups, paste_iou, proposal_layer, select_boxes,
                    shifted_anchors)
from .model import Reference as _Reference
from .model import frozen_statistics as _frozen_statistics

LOG: List[Tuple[str, ...]] = []


class Reference(_Reference):
    def __init__(self, cfg, precision: str = "float32"):
        super().__init__(cfg, precision)
        LOG.append(("init", precision, next(self.parameters()).device.type))

    def condition(self, images, labels):
        LOG.append(("condition", images.device.type))
        return super().condition(images, labels)

    def test_forward(self, images, im_hw, labels):
        LOG.append(("test_forward", images.device.type))
        return super().test_forward(images, im_hw, labels)

    def train_forward(self, batch, generator, proposals=None):
        LOG.append(("train_forward", batch["images"].device.type))
        return super().train_forward(batch, generator, proposals)


def frozen_statistics(sd, cfg, seed, device) -> None:
    LOG.append(("frozen_statistics", str(device)))
    _frozen_statistics(sd, cfg, seed, device)
