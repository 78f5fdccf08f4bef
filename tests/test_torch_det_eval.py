"""The port's detection mAP (lang2seg_tpu_torch.utils.det_eval) against the
JAX package's `utils/det_eval.py`: the same summary, exactly, on random
detections over several images and classes (score ties, duplicates and
misses included), at the default IoU thresholds and at a custom set; the
AP integral on random match lists; and the JAX tests' hand cases."""

import numpy as np
import pytest

from lang2seg_tpu.utils.det_eval import DetectionEvaluator as JDetectionEvaluator
from lang2seg_tpu.utils.det_eval import _ap_from_matches as j_ap_from_matches
from lang2seg_tpu_torch.utils.det_eval import (DetectionEvaluator,
                                               _ap_from_matches)


def _random_image(rng, num_classes=4):
    """GT boxes, and detections: jittered copies of some GTs (a few of
    them twice), boxes elsewhere, classes sometimes wrong, scores rounded
    to two digits so that ties occur."""
    g = rng.randint(0, 6)
    xy = rng.uniform(0, 200, (g, 2))
    gt = np.concatenate([xy, xy + rng.uniform(10, 80, (g, 2))], 1)
    gt_cls = rng.randint(1, num_classes + 1, g)
    hits = [i for i in range(g) if rng.rand() < 0.7]
    hits += [i for i in hits if rng.rand() < 0.3]
    det = [gt[i] + rng.normal(0, 6, 4) for i in hits]
    det_cls = [gt_cls[i] if rng.rand() < 0.85 else rng.randint(1, 5)
               for i in hits]
    for _ in range(rng.randint(0, 4)):
        a = rng.uniform(0, 250, 2)
        det.append(np.concatenate([a, a + rng.uniform(5, 60, 2)]))
        det_cls.append(rng.randint(1, num_classes + 1))
    det = np.asarray(det, np.float64).reshape(-1, 4)
    scores = np.round(rng.uniform(0, 1, len(det)), 2)
    return det, scores, np.asarray(det_cls, np.int64), gt, gt_cls


@pytest.mark.parametrize("thresholds", [None, [0.3, 0.5, 0.7]])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_matches_jax(seed, thresholds):
    rng = np.random.RandomState(seed)
    port, jax_ = DetectionEvaluator(thresholds), JDetectionEvaluator(thresholds)
    for _ in range(12):
        args = _random_image(rng)
        port.add_image(*args)
        jax_.add_image(*args)
    got, want = port.summary(), jax_.summary()
    assert got == want
    assert 0.0 < got["mAP@[.5:.95]"] < 1.0


def test_ap_from_matches_matches_jax():
    rng = np.random.RandomState(7)
    for n in (0, 1, 2, 5, 30):
        scores = np.round(rng.uniform(0, 1, n), 1)
        matches = (rng.rand(n) < 0.5).astype(float)
        for num_gt in (0, 1, int(matches.sum()) + 2):
            assert _ap_from_matches(scores, matches, num_gt) == \
                j_ap_from_matches(scores, matches, num_gt)


def test_hand_cases():
    ev = DetectionEvaluator()
    gt = np.array([[0, 0, 10, 10], [50, 50, 80, 90]], float)
    cls = np.array([1, 2])
    ev.add_image(gt, np.array([0.9, 0.8]), cls, gt, cls)
    assert ev.summary() == {"mAP@0.5": 1.0, "mAP@[.5:.95]": 1.0}
    ev = DetectionEvaluator(iou_thresholds=[0.5])
    det = np.array([[0, 0, 10, 10], [200, 200, 210, 210]], float)
    ev.add_image(det, np.array([0.9, 0.8]), np.array([1, 1]), gt,
                 np.array([1, 1]))
    assert abs(ev.summary()["mAP@0.5"] - 0.5) < 1e-9
    assert _ap_from_matches([0.9, 0.1], [1, 0], num_gt=1) == 1.0
    assert _ap_from_matches([0.9, 0.1], [0, 1], num_gt=1) == 0.5
