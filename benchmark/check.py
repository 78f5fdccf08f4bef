"""How `correct` is decided: the numbers that hold what the timed path
produced against the plain reference (the module of
`benchmark/reference/` that the configuration names, in f32 with TF32
off), each beside its limit from `benchmark/limits/`. Every function
takes that module (`ref`) or a network built from it (`reference_net`).

Where the program makes a discrete choice (which proposals NMS keeps,
which box a sentence selects), the reference follows the program's choice
and judges it, as a served model's tokens are judged by the reference's
logits; the stage that this skips is checked by itself (the reference's
own proposal layer on the program's RPN outputs must keep the same
proposals, bit for bit).

Serving and eval, for each sampled dispatch (`serve_numbers`):
  gated_rel   backbone and conditioning: the gated map the RPN and the
              heads read, relative L2 error (the response map's worst
              expression, which swings with how small its response is,
              is a diagnostic)
  rpn_rel     RPN: the proposal scores and deltas, relative L2
  prop_diff   decode, sort and NMS: proposals that differ from the
              reference's proposal layer on the program's RPN outputs
  head_rel    crop, tail and box head on the program's proposals: class
              logits and box deltas, relative L2
  sel_gap     the selected box: how far the reference's probability of the
              program's choice lies below the reference's best, relative
  box_px      the selection itself: each sentence's box against the
              reference's selection from the program's own scores and
              deltas, pixels
  mask_err    the mask head on the program's own gated map at its box and
              class: the largest probability gap
  iu_diff     the paste-back itself: each valid sentence's I and U
              against the reference's paste of the program's own mask
              probabilities on its box, pixels
Training, over the first three steps (`train_numbers`):
  loss_gap    each step's loss, relative to the reference's
  rpn_ce_gap  each step's RPN classification loss, relative (the total
              sums terms whose rounding errors cancel)
  grad_gap    the first step's gradient as the optimizer got it, by the
              worst leaf
  update_gap  the parameters' change after three steps, by the median
              leaf (the worst leaf's swings with the later steps' noise)
  prop_diff   as above, at each step
A leaf's gap is |norm(program) - norm(reference)| over the larger of the
reference's norm and the median leaf's; leaves whose reference gradient
is under a thousandth of the median leaf's are left out.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp(min=1e-30))


def reference_net(ref, cfg_tree: Dict, sd: Dict[str, torch.Tensor], device,
                  precision: str = "float32"):
    net = ref.Reference(cfg_tree, precision).to(device)
    net.load_reference_state(sd)
    return net.eval()


def proposals_diff(ref, score_pos, deltas, anchors, im_h, im_w, rois, valid,
                   pre_n: int, post_n: int, thresh: float) -> int:
    """Proposals (coordinates or validity) of the program that differ
    from the reference's proposal layer on the same RPN outputs."""
    mine = ref.proposal_layer(score_pos.float(), deltas.float(), anchors,
                              im_h, im_w, pre_n, post_n, thresh)
    diff = (mine.rois != rois).any(-1) | (mine.valid != valid.bool())
    return int(diff.sum())


def image_extents(req: Dict):
    """(scale, sh, sw, ih, iw) of an image, in the evaluator's order."""
    scale = float(req["im_scale"])
    sh = int(round(float(req["im_hw"][0][0])))
    sw = int(round(float(req["im_hw"][0][1])))
    return scale, sh, sw, int(round(sh / scale)), int(round(sw / scale))


def _sentence_extents(reqs: Sequence[Dict], per: int, device):
    """Each sentence's image scale (f32) and scaled and original extents
    (int64), as tensors on `device`."""
    ext = [image_extents(r) for r in reqs]
    scale = torch.tensor([x[0] for x in ext for _ in range(per)],
                         dtype=torch.float32, device=device)
    sh, sw, ih, iw = (torch.tensor([x[k] for x in ext for _ in range(per)],
                                   dtype=torch.int64, device=device)
                      for k in range(1, 5))
    return scale, sh, sw, ih, iw


@torch.no_grad()
def serve_numbers(ref, net, cfg_tree: Dict, reqs: Sequence[Dict],
                  rec: Dict) -> Dict[str, float]:
    """One dispatch of len(reqs) images of S expressions each. `rec` holds
    what the judged side produced: response, score_pos, deltas, rois,
    roi_valid, cls_score, bbox_pred (de-normalized), probs (E, M, M), and
    per sentence sel (E, 4), inter, union (host numbers)."""
    dev = rec["rois"].device
    c = cfg_tree
    t = c["test"]
    images = torch.cat([torch.from_numpy(r["images"]) for r in reqs]).to(dev)
    im_hw = torch.cat([torch.from_numpy(r["im_hw"]) for r in reqs]).to(dev)
    labels = torch.cat([torch.from_numpy(r["labels"]) for r in reqs]).to(dev)
    e = labels.shape[0]
    per = e // len(reqs)
    net_conv, gated, response = net.condition(images, labels)
    out = {}
    r_resp = rec["response"].float().reshape(e, -1)
    per_expr = [_rel(r_resp[i], response.reshape(e, -1)[i]) for i in range(e)]
    out["gated_rel"] = _rel(rec["gated_conv"].float(), gated)
    out["diag.resp_rel"] = max(per_expr)
    out["diag.resp_rel_median"] = sorted(per_expr)[e // 2]
    if "net_conv" in rec:
        out["diag.feat_rel"] = _rel(rec["net_conv"].float(), net_conv)
    score_pos, deltas, (h, w) = net.rpn_outputs(gated)
    out["rpn_rel"] = max(_rel(rec["score_pos"], score_pos),
                         _rel(rec["deltas"], deltas))
    m = c["model"]
    anchors = ref.shifted_anchors(h, w, m["feat_stride"], m["anchor_scales"],
                                  m["anchor_ratios"], dev)
    hw = im_hw.float()[:, None, :].expand(len(reqs), per, 2).reshape(e, 2)
    out["prop_diff"] = float(proposals_diff(
        ref, rec["score_pos"], rec["deltas"], anchors, hw[:, 0], hw[:, 1],
        rec["rois"], rec["roi_valid"], t["rpn_pre_nms_top_n"],
        t["rpn_post_nms_top_n"], t["rpn_nms_thresh"]))
    cls_score, bbox_pred = net.box_outputs(gated, rec["rois"].float())
    out["diag.cls_rel"] = _rel(rec["cls_score"], cls_score)
    out["diag.bbox_rel"] = _rel(rec["bbox_pred"], bbox_pred)
    out["head_rel"] = max(out["diag.cls_rel"], out["diag.bbox_rel"])

    scale, sh, sw, ih, iw = _sentence_extents(reqs, per, dev)
    valid = rec["roi_valid"].bool()
    box, r_idx, cls = ref.select_boxes(
        rec["rois"].float(), rec["bbox_pred"].float(),
        torch.softmax(rec["cls_score"].float(), -1), valid, scale,
        ih.float(), iw.float())
    prob = torch.softmax(cls_score.double(), -1)
    prob = torch.where(valid[..., None], prob, -1.0)
    best = prob[:, :, 1:].reshape(e, -1).amax(1)
    chosen = prob[torch.arange(e, device=dev), r_idx, cls]
    out["sel_gap"] = float(((best - chosen) / best.abs().clamp(
        min=1e-30)).max())
    sel = torch.as_tensor(rec["sel"], dtype=torch.float32, device=dev)
    out["box_px"] = float((sel - box).abs().max())

    # the mask head on the program's own gated map at its box and class
    own = rec["gated_conv"].float()
    probs = net.mask_probs(own, (sel * scale[:, None])[:, None, :],
                           cls[:, None])[:, 0]
    mine = rec["probs"].float().reshape(probs.shape)
    out["mask_err"] = float((mine - probs).abs().max())
    gt = torch.cat([torch.from_numpy(_gt_masks(r)) for r in reqs]).to(dev)
    d = c["data"]
    inter, union = ref.paste_iou(mine, sel, gt, sh, sw, ih, iw,
                                 d["max_orig_h"], d["max_orig_w"])
    pi = torch.as_tensor(rec["inter"], dtype=torch.float64, device=dev)
    pu = torch.as_tensor(rec["union"], dtype=torch.float64, device=dev)
    live = torch.from_numpy(_live(reqs)).to(dev)
    diff = (pi - inter).abs() + (pu - union).abs()
    out["iu_diff"] = float(torch.where(live, diff, 0.0).max())
    return out


def _gt_masks(req: Dict):
    """(S, Hc, Wc) per-sentence GT masks, expanded from a mask bank."""
    if "gt_mask_bank" in req:
        return req["gt_mask_bank"][req["mask_ref_idx"]]
    return req["gt_masks"]


def _live(reqs: Sequence[Dict]):
    import numpy as np
    return np.concatenate([np.asarray(r["sent_valid"], bool)
                           if "sent_valid" in r
                           else np.ones(r["labels"].shape[0], bool)
                           for r in reqs])


@torch.no_grad()
def control_serve_record(ref, net, cfg_tree: Dict, reqs: Sequence[Dict],
                         device) -> Dict:
    """The control's record of one dispatch: the reference in a lower
    precision in the program's place, through the same selection, mask
    head and paste-back."""
    c = cfg_tree
    images = torch.cat([torch.from_numpy(r["images"]) for r in reqs]).to(
        device)
    im_hw = torch.cat([torch.from_numpy(r["im_hw"]) for r in reqs]).to(device)
    labels = torch.cat([torch.from_numpy(r["labels"]) for r in reqs]).to(
        device)
    out = net.test_forward(images, im_hw, labels)
    e = labels.shape[0]
    per = e // len(reqs)
    scale, sh, sw, ih, iw = _sentence_extents(reqs, per, device)
    sel, _, cls = ref.select_boxes(out["rois"], out["bbox_pred"],
                                   torch.softmax(out["cls_score"], -1),
                                   out["roi_valid"], scale, ih.float(),
                                   iw.float())
    probs = net.mask_probs(out["gated"], (sel * scale[:, None])[:, None, :],
                           cls[:, None])[:, 0]
    gt = torch.cat([torch.from_numpy(_gt_masks(r)) for r in reqs]).to(device)
    d = c["data"]
    inter, union = ref.paste_iou(probs, sel, gt, sh, sw, ih, iw,
                                 d["max_orig_h"], d["max_orig_w"])
    return {"response": out["response"], "gated_conv": out["gated"],
            "score_pos": out["score_pos"],
            "deltas": out["deltas"], "rois": out["rois"],
            "roi_valid": out["roi_valid"], "cls_score": out["cls_score"],
            "bbox_pred": out["bbox_pred"], "probs": probs,
            "sel": sel.cpu().numpy(), "inter": inter.cpu().numpy(),
            "union": union.cpu().numpy()}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def reference_steps(ref, net, cfg_tree: Dict,
                    batches: Sequence[Dict[str, torch.Tensor]], gen_seed: int,
                    proposals: Optional[Sequence] = None,
                    record_rpn: bool = False) -> Dict:
    """Three (or len(batches)) SGD steps of the reference from its loaded
    weights, drawing from a generator seeded as the program's. With
    `proposals` each step takes that step's (rois, valid) in place of its
    own NMS output. Returns the losses of each step, the first step's
    gradients and the change of every trainable parameter, by name."""
    t = cfg_tree["train"]
    net.set_frozen()
    net.train()
    named = [(k, p) for k, p in net.reference_state_keys().items()
             if isinstance(p, torch.nn.Parameter)]
    groups = ref.param_groups(named, ref.namespace(t))
    sgd = ref.PlainSGD(groups, t["learning_rate"], t["momentum"],
                       t["grad_clip_norm"])
    before = {k: p.detach().clone() for k, p in named if p.requires_grad}
    dev = next(net.parameters()).device
    g = torch.Generator(device=dev).manual_seed(gen_seed)
    losses, grads, rpn = [], None, []
    for i, b in enumerate(batches):
        for _, p in named:
            p.grad = None
        captured = {}
        if record_rpn:
            net._capture = captured
        lo = net.train_forward(b, g, None if proposals is None
                               else proposals[i])
        lo["total_loss"].backward()
        losses.append({k: float(v.detach()) for k, v in lo.items()})
        sgd.clip_grads()
        if i == 0:
            grads = {k: p.grad.detach().clone() for k, p in named
                     if p.requires_grad}
        sgd.update()
        rpn.append(captured)
    delta = {k: (p.detach() - before[k]) for k, p in named
             if p.requires_grad}
    net._capture = None
    return {"losses": losses, "grads": grads, "delta": delta, "rpn": rpn}


def _leaf_gaps(mine: Dict[str, torch.Tensor],
               theirs: Dict[str, torch.Tensor], keep: List[str]
               ) -> Dict[str, float]:
    norms = {k: float(torch.linalg.vector_norm(theirs[k].double()))
             for k in keep}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: abs(float(torch.linalg.vector_norm(mine[k].double()))
                   - norms[k]) / max(norms[k], med, 1e-30) for k in keep}


def compared_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the rest move by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in ref_grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def train_numbers(mine: Dict, theirs: Dict) -> Dict[str, float]:
    """`mine`: the judged side's losses of each step, first gradients and
    parameter changes (by name), and `prop_diff` (its proposals against
    the reference's proposal layer on its RPN outputs); `theirs`: the
    reference's (`reference_steps`)."""
    gap = 0.0
    diag: Dict[str, float] = {}
    for step, (lp, lr) in enumerate(zip(mine["losses"], theirs["losses"])):
        for k, v in lr.items():
            g = abs(lp[k] - v) / max(abs(v), 1e-30)
            if k == "total_loss":
                gap = max(gap, g)
            diag[f"diag.loss.{k}.{step}"] = g
            diag[f"diag.value.{k}.{step}"] = v
    if len(mine["losses"]) != len(theirs["losses"]):
        gap = math.inf
    keep = compared_leaves(theirs["grads"])
    grads = _leaf_gaps(mine["grads"], theirs["grads"], keep)
    delta = _leaf_gaps(mine["delta"], theirs["delta"], keep)
    rpn_ce = max(abs(lp["rpn_cross_entropy"] - lr["rpn_cross_entropy"])
                 / max(abs(lr["rpn_cross_entropy"]), 1e-30)
                 for lp, lr in zip(mine["losses"], theirs["losses"]))
    out = {"loss_gap": gap, "rpn_ce_gap": rpn_ce,
           "grad_gap": max(grads.values()),
           "update_gap": sorted(delta.values())[len(delta) // 2],
           "prop_diff": float(mine["prop_diff"])}
    for what, gaps in (("grads", grads), ("delta", delta)):
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])
        diag[f"diag.{what}.median"] = worst[len(worst) // 2][1]
        for name, g in worst[:3]:
            diag[f"diag.{what}.worst.{name}"] = g
    diag["diag.leaves"] = float(len(keep))
    out.update(diag)
    return out


def with_limits(numbers: Dict[str, float], limits: Dict[str, float]
                ) -> List[Dict]:
    """[{name, value, limit}] in the limits file's order; a number the
    run could not make reads inf."""
    return [{"name": k, "value": numbers.get(k, math.inf), "limit": v}
            for k, v in limits.items()]
