"""Comprehension accuracy over candidate boxes.

Counterpart of `lang2seg_tpu/engine/comprehension.py` (reference
MAttNet-style eval utilities: `lib/models/eval_easy_utils.py:83-200` over
GT boxes, `eval_dets_utils.py` over detected boxes, fed by
`lib/loaders/dets_loader.py:33`): each expression scores every candidate
box and picks the best; it is a hit when that box's IoU with its GT box
is at least 0.5.

A box's score is the detection pathway's: the language-gated map (the
gate kernel, the image's map broadcast over the expressions) is cropped
at the box, through the ROI tail and the box head, and the box's largest
foreground class probability is its score (the lang2seg scoring rule, the
reference's argmax over classes 1..80 of model/test.py:256-259, restricted
to the candidates). No NMS runs: the boxes are given. The argmax and the
IoU stay on the host in NumPy, as in the JAX package.

A uint8 canvas has its means subtracted on the device, as `test_forward`
does; the JAX package's scorer feeds it to the backbone as it is.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models.network import Lang2Seg
from ..utils.metrics import np_box_iou


class ComprehensionEvaluator:
    """`model` on `device` (default the card; raises without one), in eval
    mode."""

    def __init__(self, model: Lang2Seg, cfg: Config, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg

    @torch.no_grad()
    def score_boxes(self, images: torch.Tensor, labels: torch.Tensor,
                    boxes: torch.Tensor) -> torch.Tensor:
        """images (1, H, W, 3); labels (E, T); boxes (E, B, 4) candidates
        in scaled coords, all on the model's device -> (E, B), each box's
        largest foreground class probability."""
        mdl = self.model
        net_conv = mdl.backbone.head(mdl._images(images))
        e = labels.shape[0]
        net_conv = net_conv.contiguous().expand(e, *net_conv.shape[1:])
        gated, _ = mdl._condition(net_conv, labels)
        fc7 = mdl._roi_features(gated, boxes)
        cls, _ = mdl.box_head(fc7.reshape(-1, *fc7.shape[2:]))
        prob = torch.softmax(cls, dim=-1).reshape(e, boxes.shape[1], -1)
        return prob[:, :, 1:].max(dim=-1).values

    def eval_image(self, batch: Dict, cand_boxes: np.ndarray,
                   gt_boxes: np.ndarray,
                   sent_valid: Optional[np.ndarray] = None,
                   cand_valid: Optional[np.ndarray] = None) -> Dict:
        """cand_boxes: (B, 4) candidates shared by the image's sentences
        (GT or detected boxes), scaled coords; gt_boxes: (S, 4) each
        sentence's GT box; cand_valid: (B,) masks padded candidate
        slots. Returns {hits, n} over the valid sentences."""
        dev = self.device
        labels = torch.as_tensor(np.asarray(batch["labels"])).to(dev)
        e = labels.shape[0]
        boxes = torch.as_tensor(np.asarray(cand_boxes, np.float32)).to(dev)
        scores = self.score_boxes(
            torch.as_tensor(np.ascontiguousarray(batch["images"])).to(dev),
            labels, boxes[None].expand(e, *boxes.shape)).cpu().numpy()
        if cand_valid is not None:
            scores[:, ~np.asarray(cand_valid)] = -1.0
        hits = n = 0
        for i in range(e):
            if sent_valid is not None and not sent_valid[i]:
                continue
            pred = cand_boxes[int(np.argmax(scores[i]))]
            if np_box_iou(pred, gt_boxes[i]) >= 0.5:
                hits += 1
            n += 1
        return {"hits": hits, "n": n}

    def eval_split(self, batches: Iterable[Dict]) -> Dict:
        """Comprehension over GT boxes: each image's candidates are the
        distinct GT boxes of its valid sentences (eval_easy)."""
        hits = n = 0
        for b in batches:
            cands = np.unique(b["gt_boxes"][b["sent_valid"], :4], axis=0)
            r = self.eval_image(b, cands, b["gt_boxes"][:, :4],
                                b.get("sent_valid"))
            hits += r["hits"]
            n += r["n"]
        return {"comprehension_acc": hits / max(n, 1), "n": n}

    def eval_split_dets(self, batches: Iterable[Dict], dets: "DetsLoader",
                        max_cands: int = 32, min_score: float = 0.0
                        ) -> Dict:
        """Comprehension over detected boxes (reference eval_dets_utils fed
        by dets_loader.py): the candidates of the batch's image_id from a
        dets file, scaled into canvas coords, the first `max_cands` of
        them padded to `max_cands` (one shape for every image). An image
        without detections counts its sentences in `skipped_no_dets`."""
        hits = n = skipped = 0
        for b in batches:
            cands = dets.candidates(int(b["image_id"]),
                                    scale=float(b["im_scale"]),
                                    min_score=min_score)
            if len(cands) == 0:
                skipped += int(np.sum(b.get(
                    "sent_valid", np.ones(b["labels"].shape[0], bool))))
                continue
            cands = cands[:max_cands]
            pad = np.zeros((max_cands, 4), np.float32)
            pad[:len(cands)] = cands
            valid = np.arange(max_cands) < len(cands)
            r = self.eval_image(b, pad, b["gt_boxes"][:, :4],
                                b.get("sent_valid"), cand_valid=valid)
            hits += r["hits"]
            n += r["n"]
        return {"comprehension_acc": hits / max(n, 1), "n": n,
                "skipped_no_dets": skipped}


class DetsLoader:
    """Precomputed detections (reference dets_loader.py:33), in either
    format:
      * the reference's flat format: {"dets": [{det_id, box [x y w h],
        image_id, category_id, category_name, score}]}
        (dets_loader.py:12-14), its boxes made xyxy with x + w - 1;
      * image-keyed: {image_id: [{box: [x1 y1 x2 y2], category_id,
        score}]}.
    `candidates` gives xyxy boxes in original-image coords times
    `scale` (the loader's im_scale), i.e. canvas coords."""

    def __init__(self, dets_json_path: str):
        with open(dets_json_path) as f:
            obj = json.load(f)
        self.dets: Dict[int, List[Dict]] = {}
        if isinstance(obj, dict) and "dets" in obj:
            self.Dets = {d["det_id"]: d for d in obj["dets"]}
            for d in obj["dets"]:
                x, y, w, h = d["box"]
                rec = dict(d)
                rec["box"] = [x, y, x + w - 1, y + h - 1]
                self.dets.setdefault(int(d["image_id"]), []).append(rec)
        else:
            self.dets = {int(k): v for k, v in obj.items()}
            self.Dets = {d.get("det_id", i): d
                         for i, ds in enumerate(self.dets.values())
                         for d in ds}

    def candidates(self, image_id: int, scale: float = 1.0,
                   min_score: float = 0.0) -> np.ndarray:
        ds = [d for d in self.dets.get(image_id, [])
              if d.get("score", 1.0) >= min_score]
        if not ds:
            return np.zeros((0, 4), np.float32)
        return np.asarray([d["box"] for d in ds], np.float32) * scale
