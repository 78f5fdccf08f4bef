"""Snapshots and resume.

Counterpart of `lang2seg_tpu/engine/checkpoint.py` (reference paired
snapshots, `model/train_val.py:57-159`): each snapshot holds the device
state and the host-side context, so that a resumed run replays the
exact data order. Layout: `<directory>/iter_<n>/state.pth` (a
`torch.save` of tensors and state_dicts: the model, the optimizer with
its momentum, the step and the step generator's state; read back with
`weights_only=True`) and `host_state.pkl` (the loader's iterators,
permutations and RandomState, and numpy's global RNG state). A snapshot
is written to `iter_<n>.tmp` and then renamed; the newest `keep` are
kept; `find_previous` gives the newest (reference train_val.py:214-234).

`tolerant_restore` is the reference's size-mismatch-tolerant load
(train_val.py:111-124), used for transfer init and for params files.
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _step_dirs(root: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        m = re.fullmatch(r"iter_(\d+)", d)
        if m:
            out.append((int(m.group(1)), os.path.join(root, d)))
    return sorted(out)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 120):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"iter_{step}")

    def save(self, step: int, state: Dict[str, Any],
             host_state: Optional[Dict] = None) -> str:
        """state: tensors, numbers and state_dicts (what torch.load takes
        back with weights_only=True); host_state: a picklable dict, to
        which numpy's global RNG state is added."""
        path = self.path(step)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pth"))
        hs = dict(host_state or {})
        hs.setdefault("np_random_state", np.random.get_state())
        with open(os.path.join(tmp, "host_state.pkl"), "wb") as f:
            pickle.dump(hs, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self._gc()
        return path

    def _gc(self):
        dirs = _step_dirs(self.directory)
        while len(dirs) > self.keep:
            _, path = dirs.pop(0)
            shutil.rmtree(path, ignore_errors=True)

    def find_previous(self) -> Optional[int]:
        dirs = _step_dirs(self.directory)
        return dirs[-1][0] if dirs else None

    def restore(self, step: int, map_location="cpu") -> Tuple[Dict, Dict]:
        path = self.path(step)
        state = torch.load(os.path.join(path, "state.pth"),
                           map_location=map_location, weights_only=True)
        with open(os.path.join(path, "host_state.pkl"), "rb") as f:
            host_state = pickle.load(f)
        return state, host_state


def tolerant_restore(target: Dict[str, torch.Tensor],
                     loaded: Dict[str, Any]
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, List]]:
    """Copy every entry of `loaded` whose key and shape match an entry of
    `target` (a state_dict), cast to that entry's dtype and device; keep
    the rest of `target`. Returns (the merged state_dict, what was
    skipped: `missing` target keys absent from `loaded`, `mismatched`
    keys of another shape, `unexpected` keys of `loaded` not in
    `target`)."""
    out = dict(target)
    skipped: Dict[str, List] = {"missing": [], "mismatched": [],
                                "unexpected": sorted(set(loaded) -
                                                     set(target))}
    for k, v in target.items():
        if k not in loaded:
            skipped["missing"].append(k)
            continue
        src = torch.as_tensor(np.asarray(loaded[k])) \
            if not isinstance(loaded[k], torch.Tensor) else loaded[k]
        if tuple(src.shape) != tuple(v.shape):
            skipped["mismatched"].append(
                (k, tuple(src.shape), tuple(v.shape)))
            continue
        out[k] = src.to(dtype=v.dtype, device=v.device)
    return out, skipped
