"""Params files -> the port's state_dict.

Counterpart of `lang2seg_tpu/engine/convert.py::load_params_file`
(`:239-257`). The port's keys are the reference network's keys, so:
  * a `.pth` / `.pt` file (the reference's `net.state_dict()`, or the
    port's own) is read as it is; the caller copies what matches with
    `engine/checkpoint.py::tolerant_restore`. A reference
    `vgg16_faster_rcnn` file holds `vgg.features.*` and
    `vgg.classifier.{0,3,6}.*`: the port's VGG16 takes fc6 in the
    reference's channel-major layout, and `classifier.6` (torchvision's
    1000-way layer) has no home, as in the JAX package;
  * a `.npz` file (the JAX package's flat `a/b/c` params tree, as its
    `engine/train_captioner.py` saves `model-best.npz`) is unflattened
    and carried over by `weights.from_jax_params`.

The reference's checkpoints are PyTorch 0.2/0.3 pickles written by
Python 2 (VERDICT.md:134-146). `torch.load(weights_only=True,
encoding="latin1")` reads such a state_dict, Python 2 strings included
(latin1 maps each byte of a Python 2 `str` to one character, as the
reference's own loaders read them). A file it refuses (a pickled
module, an options object beside the weights) is read with
`weights_only=False, encoding="latin1"` only when `allow_pickle` is set,
which the command-line entry points do for the files the user names
(`--pretrained`, `--params`, `--captioner-init`): such a file is
unpickled as code, and may run whatever it holds.
"""

from __future__ import annotations

import pickle
import warnings
from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..weights import from_jax_params


def load_torch_file(path: str, allow_pickle: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """The tensors of a `torch.save`d state_dict (or pickled module), on
    the CPU, by key."""
    try:
        with warnings.catch_warnings():
            # torch warns that pickle arguments need weights_only=False,
            # yet its weights-only unpickler decodes Python 2 strings with
            # this encoding (a non-ASCII key fails as utf-8)
            warnings.filterwarnings("ignore", "pickle_load_args only works")
            obj = torch.load(path, map_location="cpu", weights_only=True,
                             encoding="latin1")
    except pickle.UnpicklingError:
        if not allow_pickle:
            raise
        obj = torch.load(path, map_location="cpu", weights_only=False,
                         encoding="latin1")
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {str(k): (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.asarray(v)))
            for k, v in obj.items()
            if isinstance(v, (torch.Tensor, np.ndarray))}


def load_npz_tree(path: str) -> Dict:
    """A JAX params tree saved flat with '/'-joined keys -> nested dicts
    of numpy arrays."""
    tree: Dict = {}
    with np.load(path, allow_pickle=False) as data:
        for flat_key in data.files:
            node = tree
            *parents, leaf = flat_key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = data[flat_key]
    return tree


def load_params_file(path: str, cfg: Config, allow_pickle: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """A params file as a (possibly partial) port state_dict on the CPU."""
    if path.endswith(".npz"):
        return dict(from_jax_params(load_npz_tree(path), cfg))
    if path.endswith((".pth", ".pt")):
        return load_torch_file(path, allow_pickle)
    raise ValueError(f"unsupported params file: {path}")
