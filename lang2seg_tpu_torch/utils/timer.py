"""Named wall-clock timers with running averages.

Counterpart of `lang2seg_tpu/utils/timer.py` (reference Timer,
`lib/utils/timer.py:12-44`, which wraps each train step and prints
`speed: %.3fs / iter`). Times are host times: the caller synchronises
with the card (a loss read, `torch.cuda.synchronize`) where a device
time is meant.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict


class Timer:
    def __init__(self):
        self._start: Dict[str, float] = {}
        self._total = defaultdict(float)
        self._calls = defaultdict(int)

    def tic(self, name: str = "default"):
        self._start[name] = time.perf_counter()

    def toc(self, name: str = "default") -> float:
        dt = time.perf_counter() - self._start[name]
        self._total[name] += dt
        self._calls[name] += 1
        return dt

    def average_time(self, name: str = "default") -> float:
        return self._total[name] / max(self._calls[name], 1)
