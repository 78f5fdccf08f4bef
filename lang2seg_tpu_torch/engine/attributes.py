"""Attribute prediction scores: precision / recall / F1 over each ref's
attribute words.

Counterpart of `lang2seg_tpu/engine/attributes.py` (reference
`lib/models/eval_easy_utils.py:17-80`): the predicted words of a ref are
those whose sigmoid score is at least 0.5; P = correct / predicted,
R = correct / ground truth, F1 their harmonic mean, micro-averaged over
the refs (-1 where a ratio has no denominator). `attribute_scorer` gives
the `score_fn` of a model on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from ..device import resolve_device


def compute_overall(predictions: List[Dict]) -> Dict[str, float]:
    """predictions: [{gd_att_wds: [str], pred_att_wds: [str]}]
    (reference compute_overall, eval_easy_utils.py:17-38)."""
    overall = {"precision": -1.0, "recall": -1.0, "f1": -1.0}
    np_, nr, nc = 0, 0, 0
    for item in predictions:
        cpts, pred = item["gd_att_wds"], item["pred_att_wds"]
        nc += len(set(cpts) & set(pred))
        np_ += len(pred)
        nr += len(cpts)
    if np_ > 0:
        overall["precision"] = nc / np_
    if nr > 0:
        overall["recall"] = nc / nr
    if np_ > 0 and nr > 0 and (overall["precision"] + overall["recall"]) > 0:
        overall["f1"] = (2 * overall["precision"] * overall["recall"]
                         / (overall["precision"] + overall["recall"]))
    return overall


def attribute_scorer(model, device="cuda") -> Callable:
    """score_fn(images (1, H, W, 3), boxes (1, B, 4)) -> (1, B, A) numpy
    scores of `model.predict_attribute_scores` on `device` (default the
    card; raises without one), the model in eval mode."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def score_fn(images, boxes):
        out = model.predict_attribute_scores(
            torch.as_tensor(np.ascontiguousarray(images)).to(dev),
            torch.as_tensor(np.ascontiguousarray(boxes)).to(dev))
        return out.cpu().numpy()
    return score_fn


def eval_attributes(loader, score_fn: Callable, split: str,
                    thresh: float = 0.5, max_refs: int = 16) -> Dict:
    """Attribute prediction over a split's refs that carry attribute words
    (eval_easy_utils.py:60-70), through `loader.iter_attribute_batches`.
    score_fn(images (1, H, W, 3), boxes (1, B, 4)) -> scores (1, B, A) in
    [0, 1] (e.g. `attribute_scorer(model)`). Returns {overall: {precision,
    recall, f1}, n_refs}."""
    predictions: List[Dict] = []
    for data in loader.iter_attribute_batches(split, max_refs=max_refs):
        scores = np.asarray(score_fn(data["images"], data["boxes"]))[0]
        for i, (rid, gd) in enumerate(zip(data["ref_ids"],
                                          data["gd_att_wds"])):
            pred = [loader.ix_to_att[j]
                    for j in np.flatnonzero(scores[i] >= thresh)]
            predictions.append({"ref_id": rid, "gd_att_wds": gd,
                                "pred_att_wds": pred})
    return {"overall": compute_overall(predictions),
            "n_refs": len(predictions)}
