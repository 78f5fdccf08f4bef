"""RPN anchor targets and ROI proposal targets, batched over expressions.

Counterpart of `lang2seg_tpu/ops/targets.py::anchor_targets` and
`proposal_targets` (reference `layer_utils/anchor_target_layer.py:19-153`,
`layer_utils/proposal_target_layer.py:22-204`), with an expression axis E
in front of every argument instead of a vmap. Fixed shapes throughout, so
a training step holds no host synchronisation: candidate sets are masks,
`npr.choice` subsampling is a sort of random priorities.

Random draws. The JAX functions draw uniforms from a key; here the same
uniforms are an argument (`draws`), or are drawn from a `torch.Generator`
on its own device. The tests reproduce the JAX key chain and pass its
numbers in, so the selections can be compared exactly.

Per-example draws. With stable example ids (`expr_uid`), the uniforms
come from `example_uniforms` instead: a counter-based hash of (a per-step
key, the example's uid, the draw's stream, the element's index) in int64
tensor ops on the device, so that an example draws the same subsample
whichever batch position, block or data-parallel rank it lands in (JAX
folds the uid into the step's sampling key, models/network.py:244-250).
The hash is not JAX's threefry: the property is the contract, not the
bits.

Priority order. A class keeps its members with the smallest draws. Both
samplers sort their masked keys with a stable sort, so equal keys keep
ascending index order: the tie order of `lax.top_k` (anchor sampler) and
of the stable `jnp.argsort` (ROI sampler). torch.topk promises no tie
order and is not used.

Row selection. Where the JAX code selects matched GT rows and mask
points with one-hot matmuls at HIGHEST precision (exact, a TPU lowering
choice), the port gathers with integer indices: the same values, with no
matmul that TF32 could round.

No NaN guard: the JAX package's `_guard` works around a miscompile of
its CPU backend; `encode_boxes` clamps extents, so targets are finite.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..device import device_constant
from .boxes import box_iou, encode_boxes

_BIG = 1e9


class AnchorTargets(NamedTuple):
    labels: torch.Tensor            # (E, N) int32 in {-1, 0, 1}
    bbox_targets: torch.Tensor      # (E, N, 4)
    bbox_inside_w: torch.Tensor     # (E, N) 0/1
    bbox_outside_w: torch.Tensor    # (E, N) per-anchor weight


class ProposalTargets(NamedTuple):
    rois: torch.Tensor              # (E, R, 4) sampled rois [x1 y1 x2 y2]
    labels: torch.Tensor            # (E, R) int32 class (0 = bg)
    bbox_targets: torch.Tensor      # (E, R, 4) compact per-roi deltas
    bbox_weight: torch.Tensor       # (E, R) 1.0 for fg rois
    mask_targets: torch.Tensor      # (E, F, S, S) float32 {0, 1}
    mask_weight: torch.Tensor       # (E, F) 1.0 for true-fg slots
    roi_valid: torch.Tensor         # (E, R) bool


def _uniforms(draws, generator, shapes, device):
    """`draws` moved to `device`, or fresh uniforms of `shapes` from
    `generator` (on the generator's device)."""
    if draws is None:
        if generator is None:
            raise ValueError("targets: pass `draws` or a torch.Generator")
        draws = [torch.rand(s, generator=generator, device=generator.device)
                 for s in shapes]
    return [d.to(device=device, dtype=torch.float32) for d in draws]


_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant,
    by 16-bit halves of c so that no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche mixer (xorshift-multiply, `lowbias32`) on int64
    tensors holding 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def step_key(generator: torch.Generator) -> torch.Tensor:
    """The per-step sampling key of `example_uniforms`: two 32-bit words
    (int64) drawn from `generator`, on its device."""
    return torch.randint(0, 1 << 32, (2,), generator=generator,
                         device=generator.device, dtype=torch.int64)


def example_uniforms(key: torch.Tensor, uid: torch.Tensor, stream: int,
                     length: int) -> torch.Tensor:
    """(E, length) f32 uniforms in [0, 1) on 24 bits, a function of the
    step `key`, each example's `uid` (E,), the `stream` (one per draw of
    a step) and the element index alone."""
    key = key.to(uid.device)
    u = uid.to(torch.int64) & _MASK32
    seed = _mix32(_mix32(key[0] ^ u)
                  ^ ((key[1] + stream * 0x9E3779B9) & _MASK32))    # (E,)
    idx = torch.arange(length, dtype=torch.int64, device=uid.device)
    h = _mix32(_mix32((seed[:, None] + idx) & _MASK32) ^ key[1])
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


@torch.no_grad()
def anchor_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, im_h: torch.Tensor,
                   im_w: torch.Tensor,
                   draws: Optional[Sequence[torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None,
                   rpn_batchsize: int = 256, fg_fraction: float = 0.5,
                   pos_overlap: float = 0.7, neg_overlap: float = 0.3,
                   clobber_positives: bool = False) -> AnchorTargets:
    """RPN training targets.

    anchors: (N, 4); gt_boxes: (E, M, 5) [x1 y1 x2 y2 cls]; gt_valid:
    (E, M) bool; im_h / im_w: (E,) true image extents (anchors outside are
    don't-care). draws: (u_pos, u_neg), each (E, N) uniform in [0, 1),
    the JAX function's `uniform(k_pos)` and `uniform(k_neg)`.
    Parity: anchor_target_layer.py:19-153 with border=0."""
    e, m = gt_boxes.shape[:2]
    n = anchors.shape[0]
    dev = anchors.device
    u_pos, u_neg = _uniforms(draws, generator, [(e, n), (e, n)], dev)
    ih, iw = im_h.reshape(e, 1), im_w.reshape(e, 1)
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < iw) & (anchors[:, 3] < ih))     # (E, N)

    iou = box_iou(anchors, gt_boxes[..., :4])                    # (E, N, M)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    iou = torch.where(inside[..., None], iou, -1.0)
    argmax_gt = torch.argmax(iou, dim=2)                         # first max
    max_iou = torch.amax(iou, dim=2)

    # per-gt best anchors: any anchor matching the column max (ties
    # included, as np.where(overlaps == gt_max) in the reference)
    gt_max = torch.amax(iou, dim=1)                              # (E, M)
    is_gt_best = torch.any((iou == gt_max[:, None, :])
                           & gt_valid[:, None, :]
                           & (gt_max[:, None, :] > -1.0), dim=2) & inside

    neg = inside & (max_iou < neg_overlap)
    pos = inside & (is_gt_best | (max_iou >= pos_overlap))
    if clobber_positives:
        pos = pos & ~(max_iou < neg_overlap)
    else:
        neg = neg & ~pos

    # each class keeps its budget-many smallest draws: a stable ascending
    # sort of the masked keys (non-members last, at +inf)
    num_fg = int(fg_fraction * rpn_batchsize)
    num_pos_kept = torch.clamp(pos.sum(1), max=num_fg)           # (E,)
    num_bg = rpn_batchsize - num_pos_kept
    kept = []
    for mask, u, budget, count in ((pos, u_pos, num_fg, num_pos_kept),
                                   (neg, u_neg, rpn_batchsize, num_bg)):
        k = min(budget, n)
        key = torch.where(mask, u, torch.inf)
        vals, idx = torch.sort(key, dim=1, stable=True)
        keep = ((torch.arange(k, device=dev)[None, :] < count[:, None])
                & (vals[:, :k] != torch.inf))
        kept.append(torch.zeros_like(mask).scatter_(1, idx[:, :k], keep))
    pos_kept, neg_kept = kept
    labels = torch.where(pos_kept, 1, torch.where(neg_kept, 0, -1)).to(
        torch.int32)

    matched = torch.gather(gt_boxes[..., :4], 1,
                           argmax_gt[..., None].expand(e, n, 4))
    tgt = encode_boxes(anchors[None], matched)
    tgt = torch.where(inside[..., None], tgt, 0.0)

    inside_w = (labels == 1).float()
    sampled = (labels >= 0).float()
    outside_w = sampled / torch.clamp(sampled.sum(1, keepdim=True), min=1.0)
    return AnchorTargets(labels, tgt, inside_w, outside_w)


@torch.no_grad()
def proposal_targets(rois: torch.Tensor, roi_valid: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                     gt_masks: torch.Tensor,
                     draws: Optional[Sequence[torch.Tensor]] = None,
                     generator: Optional[torch.Generator] = None,
                     num_rois: int = 256, fg_fraction: float = 0.25,
                     fg_thresh: float = 0.5, bg_thresh_hi: float = 0.5,
                     bg_thresh_lo: float = 0.0, mask_size: int = 14,
                     normalize_means=(0., 0., 0., 0.),
                     normalize_stds=(0.1, 0.1, 0.2, 0.2),
                     use_gt: bool = False) -> ProposalTargets:
    """Sample ROIs and build classification, regression and mask targets.

    rois: (E, P, 4) proposals; roi_valid: (E, P) bool; gt_boxes: (E, M,
    5); gt_valid: (E, M); gt_masks: (E, M, H, W) {0, 1} uint8. draws:
    (u_fg, u_bg) each (E, P + M) and u_rep (E, R), uniform in [0, 1): the
    JAX function's `uniform(k_fg)`, `uniform(k_bg)`, and the
    with-replacement bg index floor(u_rep * bg_count), which stands for
    its `randint(k_rep, 0, bg_count)`. Output layout: fg slots first, then
    bg, as the reference concatenates them. Parity:
    proposal_target_layer.py:22-204; GT boxes are candidates iff use_gt,
    or as the no-fg fallback."""
    e, p = rois.shape[:2]
    m = gt_boxes.shape[1]
    r = num_rois
    f = int(round(fg_fraction * num_rois))
    dev = rois.device
    u_fg, u_bg, u_rep = _uniforms(draws, generator,
                                  [(e, p + m), (e, p + m), (e, r)], dev)

    cand = torch.cat([rois, gt_boxes[..., :4]], dim=1)         # (E, P+M, 4)
    is_gt = torch.arange(p + m, device=dev) >= p
    iou = box_iou(cand, gt_boxes[..., :4])                      # (E, P+M, M)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    max_iou = torch.amax(iou, dim=2)
    gt_assign = torch.argmax(iou, dim=2)
    cand_valid = torch.cat([roi_valid, gt_valid], dim=1)

    fg = cand_valid & (max_iou >= fg_thresh)
    bg = (cand_valid & (max_iou < bg_thresh_hi) & (max_iou >= bg_thresh_lo)
          & ~is_gt)
    if not use_gt:
        any_prop_fg = torch.any(fg & ~is_gt, dim=1, keepdim=True)
        fg = torch.where(is_gt, fg & ~any_prop_fg, fg)
    fg_count = fg.sum(1)
    bg_count = bg.sum(1)

    # candidate index of each rank: members first in random order
    fg_by_rank = torch.sort(u_fg + (~fg).float() * _BIG, dim=1,
                            stable=True).indices
    bg_by_rank = torch.sort(u_bg + (~bg).float() * _BIG, dim=1,
                            stable=True).indices

    # fg slots: min(f, fg_count) real fg, drawn without replacement; with
    # no bg candidates every slot is fg, cycling over the fg candidates
    all_fg = (bg_count == 0) & (fg_count > 0)
    fg_take = torch.where(all_fg, r, torch.clamp(fg_count, max=f))
    slot = torch.arange(r, device=dev)[None, :]
    is_fg_slot = slot < fg_take[:, None]
    safe_fg = torch.clamp(fg_count, min=1)[:, None]
    safe_bg = torch.clamp(bg_count, min=1)[:, None]
    fg_src = torch.gather(fg_by_rank, 1, slot % safe_fg)
    # bg slots: without replacement if there are enough bg candidates,
    # else uniform with replacement
    bg_pos = slot - fg_take[:, None]
    bg_rand = torch.minimum(torch.floor(u_rep * safe_bg).long(), safe_bg - 1)
    need_bg = r - fg_take
    bg_idx = torch.where((bg_count >= need_bg)[:, None],
                         torch.clamp(bg_pos, 0, p + m - 1) % safe_bg, bg_rand)
    bg_src = torch.gather(bg_by_rank, 1, bg_idx)
    sel = torch.where(is_fg_slot, fg_src, bg_src)               # (E, R)

    out_rois = torch.gather(cand, 1, sel[..., None].expand(e, r, 4))
    out_valid = torch.where(is_fg_slot, torch.gather(fg, 1, sel),
                            torch.gather(bg, 1, sel))
    gt_idx = torch.gather(gt_assign, 1, sel)
    matched_gt = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(e, r, 5))
    labels = torch.where(is_fg_slot & out_valid,
                         matched_gt[..., 4].to(torch.int32), 0).to(
                             torch.int32)

    means = device_constant(normalize_means, dev)
    stds = device_constant(normalize_stds, dev)
    tgt = (encode_boxes(out_rois, matched_gt[..., :4]) - means) / stds
    bbox_w = (labels > 0).float()
    tgt = tgt * bbox_w[..., None]

    # mask targets of the fg slots: nearest points of each slot's GT mask
    # at the ROI's S x S sample grid (integer floor coordinates)
    s = mask_size
    fr = torch.floor(out_rois[:, :f]).to(torch.int64)           # (E, F, 4)
    x1, y1, x2, y2 = fr.unbind(-1)
    t2 = 2 * torch.arange(s, device=dev) + 1
    mh, mw = gt_masks.shape[-2:]
    ys = torch.clamp(y1[..., None] + (t2 * (y2 - y1 + 1)[..., None])
                     // (2 * s), 0, mh - 1)                     # (E, F, S)
    xs = torch.clamp(x1[..., None] + (t2 * (x2 - x1 + 1)[..., None])
                     // (2 * s), 0, mw - 1)
    ei = torch.arange(e, device=dev)[:, None, None, None]
    mask_t = gt_masks[ei, gt_idx[:, :f, None, None], ys[..., :, None],
                      xs[..., None, :]].float()                 # (E, F, S, S)
    mask_w = (is_fg_slot[:, :f] & out_valid[:, :f]).float()
    return ProposalTargets(out_rois, labels, tgt, bbox_w, mask_t, mask_w,
                           out_valid)
