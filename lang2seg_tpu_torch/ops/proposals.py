"""RPN proposal generation, batched over expressions.

Parity: `lang2seg_tpu/ops/proposals.py::proposal_layer` and reference
`layer_utils/proposal_layer.py:19-68`: decode deltas -> clip -> stable
descending sort to pre_nms_n -> NMS -> gather to post_nms_n. Outputs are
padded to post_nms_n with a validity mask; padded slots hold the top
box (index 0), as the reference's fixed-shape gather does. One NMS call
covers all E expressions (one kernel launch per request on a card).
`proposal_top_layer` is test mode 'top': the top-N anchors, no NMS.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .boxes import clip_boxes, decode_boxes
from .nms_cuda import nms_batched


class Proposals(NamedTuple):
    rois: torch.Tensor      # (E, post_nms_n, 4)
    scores: torch.Tensor    # (E, post_nms_n)
    valid: torch.Tensor     # (E, post_nms_n) bool


@torch.no_grad()
def proposal_layer(scores: torch.Tensor, deltas: torch.Tensor,
                   anchors: torch.Tensor, im_h, im_w, pre_nms_n: int,
                   post_nms_n: int, nms_thresh: float) -> Proposals:
    """scores: (E, N) positive-class probs; deltas: (E, N, 4); anchors:
    (N, 4). im_h / im_w: true (unpadded) image extent for clipping, one
    for all expressions (scalars) or one per expression ((E,) tensors: a
    training batch holds images of different extents). No gradient flows
    through the proposals (the reference detaches the rois before
    cropping, network.py:117)."""
    e, n = scores.shape
    im_h, im_w = (torch.as_tensor(v, dtype=torch.float32,
                                  device=scores.device) for v in (im_h, im_w))
    if im_h.dim() == 1:
        # (E,) -> (E, 1, 1) against the (E, N, 1) box coordinates
        im_h, im_w = im_h.reshape(e, 1, 1), im_w.reshape(e, 1, 1)
    boxes = clip_boxes(decode_boxes(anchors, deltas.float()), im_h, im_w)
    k = min(pre_nms_n, n)
    # stable sort: equal scores keep ascending-index order, the tie order
    # of the reference's lax.sort (torch.topk promises none)
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
    top_scores = torch.gather(scores, 1, order)
    top_boxes = torch.gather(boxes, 1, order[..., None].expand(e, k, 4))
    keep_idx, keep_mask = nms_batched(
        top_boxes.contiguous(),
        torch.ones((e, k), dtype=torch.bool, device=scores.device),
        nms_thresh, post_nms_n)
    ki = keep_idx.long()
    rois = torch.gather(top_boxes, 1, ki[..., None].expand(e, post_nms_n, 4))
    return Proposals(rois, torch.gather(top_scores, 1, ki), keep_mask)


@torch.no_grad()
def proposal_top_layer(scores: torch.Tensor, deltas: torch.Tensor,
                       anchors: torch.Tensor, im_h, im_w, top_n: int,
                       generator: Optional[torch.Generator] = None,
                       order: Optional[torch.Tensor] = None) -> Proposals:
    """NMS-free proposals of test mode 'top' (`lang2seg_tpu/ops/proposals.
    py::proposal_top_layer`, reference `proposal_top_layer.py:18-67`):
    per expression the top_n anchors by score (a stable sort: equal scores
    in ascending index order, as `lax.top_k` breaks ties), decoded and
    clipped. With fewer than top_n anchors the reference draws top_n
    indices uniformly with replacement instead: here from `generator`, on
    its own device. `order` (E, top_n) injects the indices. Every row is
    valid."""
    e, n = scores.shape
    if order is None:
        if n < top_n:
            if generator is None:
                raise ValueError("proposal_top_layer: fewer anchors than "
                                 "top_n needs a torch.Generator")
            order = torch.randint(0, n, (e, top_n), generator=generator,
                                  device=generator.device)
        else:
            order = torch.sort(-scores, dim=1, stable=True).indices[:, :top_n]
    order = order.to(scores.device, torch.int64)
    im_h, im_w = (torch.as_tensor(v, dtype=torch.float32,
                                  device=scores.device) for v in (im_h, im_w))
    boxes = decode_boxes(anchors[order], torch.gather(
        deltas.float(), 1, order[..., None].expand(e, top_n, 4)))
    return Proposals(clip_boxes(boxes, im_h, im_w),
                     torch.gather(scores, 1, order),
                     torch.ones((e, top_n), dtype=torch.bool,
                                device=scores.device))
