"""The port's copy of the training loader's pieces that it needs so far.

Counterpart of `lang2seg_tpu/data/loader.py`; only the caption framing
(`GtBatchLoader._caption_targets`, reference cycle_loader.py:297-309) is
ported. The loader itself (RefCOCO h5/json, image decode, RLE masks, the
prefetch thread) is not.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def caption_targets(labels: np.ndarray) -> Dict[str, np.ndarray]:
    """(E, L) token ids, 0 pad -> the captioner's targets: `cap_labels`
    (E, L + 2) int32, BOS = 0 in column 0, the tokens, then 0s (the first
    is EOS), and `cap_masks` (E, L + 2) f32, 1 over BOS, the tokens and
    the EOS."""
    e, length = labels.shape
    cap = np.zeros((e, length + 2), np.int32)
    cap[:, 1:-1] = labels
    nonzeros = (cap != 0).sum(axis=1) + 2
    mask = (np.arange(length + 2)[None, :] < nonzeros[:, None]).astype(
        np.float32)
    return {"cap_labels": cap, "cap_masks": mask}
