"""Caption-pretraining batches.

Counterpart of `lang2seg_tpu/data/caption_loader.py` (reference
CaptionLoader, `lib/loaders/caption_loader.py:49`): training batches
with BOS/EOS-framed caption targets always on, from which
`engine/train_captioner.py::extract_caption_features` takes the region
features.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .loader import GtBatchLoader, caption_targets


class CaptionBatchLoader(GtBatchLoader):
    def get_caption_batch(self, split: str = "train",
                          num_refs: Optional[int] = None
                          ) -> Dict[str, np.ndarray]:
        batch = self.get_batch(split, num_images=None, num_expr=num_refs)
        batch.update(caption_targets(batch["labels"]))
        return batch
