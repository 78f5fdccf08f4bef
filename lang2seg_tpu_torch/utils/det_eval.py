"""COCO-style detection evaluation for the pretraining path: the port's
copy of `lang2seg_tpu/utils/det_eval.py`.

The reference's detection eval
(`pyutils/mask-faster-rcnn/tools/test_net.py` / `reval.py`, which call
pycocotools' COCOeval): per-class AP via the precision-recall integral,
reported at IoU 0.5 and averaged over [.5:.95:.05]. Pure NumPy (no
pycocotools); the matching rule (greedy by score,
one GT per detection, IoU threshold) follows the COCO protocol.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

from .metrics import np_box_iou


def _ap_from_matches(scores, matches, num_gt) -> float:
    """All-point-interpolated AP given per-detection (score, is_tp)."""
    if num_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores))
    tp = np.asarray(matches, dtype=np.float64)[order]
    fp = 1.0 - tp
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / num_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-12)
    # precision envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    # integrate over recall deltas
    idx = np.where(np.diff(np.concatenate([[0.0], recall])) > 0)[0]
    return float(np.sum(precision[idx]
                        * np.diff(np.concatenate([[0.0], recall]))[idx]))


class DetectionEvaluator:
    """Accumulate per-image detections + GT; report mAP."""

    def __init__(self, iou_thresholds=None):
        self.iou_thresholds = (list(iou_thresholds) if iou_thresholds
                               else [0.5 + 0.05 * i for i in range(10)])
        # per (class, threshold): lists of detection scores / tp flags
        self._scores = defaultdict(list)
        self._tps = defaultdict(list)
        self._num_gt = defaultdict(int)

    def add_image(self, det_boxes: np.ndarray, det_scores: np.ndarray,
                  det_classes: np.ndarray, gt_boxes: np.ndarray,
                  gt_classes: np.ndarray):
        """det_boxes (D, 4), det_scores (D,), det_classes (D,);
        gt_boxes (G, 4), gt_classes (G,). All original-image coords."""
        for c in np.unique(np.concatenate([det_classes, gt_classes])):
            d_idx = np.where(det_classes == c)[0]
            g_idx = np.where(gt_classes == c)[0]
            for t in self.iou_thresholds:
                self._num_gt[(c, t)] += len(g_idx)
            if len(d_idx) == 0:
                continue
            order = d_idx[np.argsort(-det_scores[d_idx])]
            for t in self.iou_thresholds:
                taken = set()
                for di in order:
                    best, best_g = 0.0, -1
                    for gi in g_idx:
                        if gi in taken:
                            continue
                        iou = np_box_iou(det_boxes[di], gt_boxes[gi])
                        if iou > best:
                            best, best_g = iou, gi
                    tp = best >= t
                    if tp:
                        taken.add(best_g)
                    self._scores[(c, t)].append(float(det_scores[di]))
                    self._tps[(c, t)].append(1.0 if tp else 0.0)

    def summary(self) -> Dict[str, float]:
        classes = sorted({c for (c, _) in self._num_gt})
        ap_by_t = {}
        for t in self.iou_thresholds:
            aps = [
                _ap_from_matches(self._scores[(c, t)], self._tps[(c, t)],
                                 self._num_gt[(c, t)])
                for c in classes if self._num_gt[(c, t)] > 0]
            ap_by_t[t] = float(np.mean(aps)) if aps else 0.0
        out = {"mAP@0.5": ap_by_t.get(0.5, 0.0),
               "mAP@[.5:.95]": float(np.mean(list(ap_by_t.values())))}
        return out
