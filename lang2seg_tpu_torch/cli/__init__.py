"""Command-line entry points of the port: `python -m
lang2seg_tpu_torch.cli.train`, `python -m lang2seg_tpu_torch.cli.eval` and
`python -m lang2seg_tpu_torch.cli.eval_captions` (the caption metrics of a
caption variant's decodes) take the flags of `add_common_flags` and derive
their config and paths from them with `setup`; the offline tools
`cli.prepro` (REFER -> data.json + data.h5) and
`cli.make_coco_minus_refer` (the pretraining instances) take their own."""

from __future__ import annotations

import argparse
import os
from typing import Tuple

from ..config import VARIANTS, Config, apply_variant, load_config


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--variant", default="baseline", choices=VARIANTS)
    p.add_argument("--dataset", default="refcoco",
                   choices=["refcoco", "refcoco+", "refcocog", "refclef"])
    p.add_argument("--split-by", default="unc")
    p.add_argument("--id", default="exp0", help="experiment id")
    p.add_argument("--data-root", default="data")
    p.add_argument("--prepro-dir", default=None,
                   help="dir with data.json/data.h5 (default: "
                        "cache/prepro/<dataset_splitby>)")
    p.add_argument("--image-dir", default=None)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--cfg", default=None, help="YAML config overlay")
    p.add_argument("--set", dest="overrides", nargs="*", default=[],
                   help="dotted KEY VALUE config overrides")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")


def setup(args) -> Tuple[Config, str, str, str]:
    """(cfg, tag, prepro_dir, output_dir) of the common flags: the config
    file with its overrides and the variant's preset, the dataset
    (refcocog's longer sentences), the image directory; `tag` is
    `<dataset>_<split_by>`."""
    cfg = load_config(args.cfg, args.overrides)
    apply_variant(cfg, args.variant)
    d = cfg.data
    d.dataset, d.split_by, d.data_root = (args.dataset, args.split_by,
                                          args.data_root)
    if args.dataset == "refcocog":
        d.max_len = 20
    if args.image_dir:
        d.image_dir = args.image_dir
    tag = f"{args.dataset}_{args.split_by}"
    prepro_dir = args.prepro_dir or os.path.join("cache", "prepro", tag)
    output_dir = args.output_dir or os.path.join(
        cfg.exp_dir, tag, f"{args.variant}_{args.id}")
    return cfg, tag, prepro_dir, output_dir


def open_loader(loader_cls, prepro_dir: str, cfg: Config):
    """`loader_cls` over `<prepro_dir>/data.json` and `data.h5`; the
    vocabulary sizes of the model and its captioner follow the data."""
    loader = loader_cls(os.path.join(prepro_dir, "data.json"),
                        os.path.join(prepro_dir, "data.h5"), cfg,
                        seed=cfg.seed)
    cfg.model.vocab_size = cfg.model.cap_vocab_size = loader.vocab_size
    return loader
