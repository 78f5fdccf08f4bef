"""Faults planted under the timed path, for the tests and the readings
that show `correct` catches them (`benchmark/calibrate.py --fault`).

* `frozen`: the training step returns its state unchanged (the SGD update
  is skipped);
* `half`: the training step leaves out half of the batch's expressions
  and takes its means over the rest;
* `answer`: each served sentence's selected box is moved by 8 pixels
  where the evaluator produces it.
Each `plant_<fault>()` returns a function that removes it.
"""

from __future__ import annotations

from typing import Callable


def plant_frozen() -> Callable[[], None]:
    from lang2seg_tpu_torch.engine import train_state
    orig = train_state._clip_and_step
    train_state._clip_and_step = lambda state, grads: None

    def undo():
        train_state._clip_and_step = orig
    return undo


HALF_KEYS = ("img_idx", "labels", "gt_boxes", "gt_masks", "gt_valid",
             "cap_labels", "cap_masks")


def plant_half() -> Callable[[], None]:
    from lang2seg_tpu_torch.models.network import Lang2Seg
    orig = Lang2Seg.train_forward

    def half(self, batch, *args, **kwargs):
        e = batch["img_idx"].shape[0] // 2
        batch = {k: (v[:e] if k in HALF_KEYS else v) for k, v in batch.items()}
        return orig(self, batch, *args, **kwargs)

    Lang2Seg.train_forward = half

    def undo():
        Lang2Seg.train_forward = orig
    return undo


def plant_answer() -> Callable[[], None]:
    from lang2seg_tpu_torch.engine.evaluator import Evaluator
    orig = Evaluator._select_fn

    def moved(*args, **kwargs):
        sel, cls = orig(*args, **kwargs)
        return sel + 8.0, cls

    Evaluator._select_fn = staticmethod(moved)

    def undo():
        Evaluator._select_fn = staticmethod(orig)
    return undo


def plant(name: str) -> Callable[[], None]:
    return globals()[f"plant_{name}"]()
