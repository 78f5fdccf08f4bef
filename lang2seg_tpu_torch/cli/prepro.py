"""Preprocessing CLI (the reference's `tools/prepro.py:231-291`): the
REFER annotations under `--data-root` -> `data.json` + `data.h5`, which
`cli.train` and `cli.eval` read from `--prepro-dir`.

  python -m lang2seg_tpu_torch.cli.prepro --data-root data \\
      --dataset refcoco --split-by unc --output-dir cache/prepro/refcoco_unc
"""

from __future__ import annotations

import argparse
import os

from ..data.prepro import run_prepro


def main(argv=None):
    p = argparse.ArgumentParser(description="REFER -> data.json + data.h5")
    p.add_argument("--data-root", default="data")
    p.add_argument("--dataset", default="refcoco")
    p.add_argument("--split-by", default="unc")
    p.add_argument("--output-dir", default=None,
                   help="default: cache/prepro/<dataset>_<split-by>")
    p.add_argument("--max-length", type=int, default=None,
                   help="label columns (default: 10, 20 for refcocog)")
    p.add_argument("--word-count-threshold", type=int, default=5)
    args = p.parse_args(argv)

    out = args.output_dir or os.path.join(
        "cache", "prepro", f"{args.dataset}_{args.split_by}")
    jp, hp = run_prepro(args.data_root, args.dataset, args.split_by, out,
                        max_length=args.max_length,
                        count_threshold=args.word_count_threshold)
    print(f"wrote {jp} and {hp}")
    return jp, hp


if __name__ == "__main__":
    main()
