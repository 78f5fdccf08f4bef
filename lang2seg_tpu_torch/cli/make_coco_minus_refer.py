"""Build the coco_minus_refer pretraining instances json (the reference's
`pyutils/mask-faster-rcnn/tools/make_coco_minus_refer_instances.py`): COCO
train2014 annotations without the images of the refcoco_unc and
refcocog_umd val / test splits.

  python -m lang2seg_tpu_torch.cli.make_coco_minus_refer \\
      --coco-instances data/coco/annotations/instances_train2014.json \\
      --data-root data --out data/coco_minus_refer/instances.json
"""

from __future__ import annotations

import argparse

from ..data.coco_detection import make_coco_minus_refer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--coco-instances", required=True)
    p.add_argument("--data-root", default="data")
    p.add_argument("--out", required=True)
    p.add_argument("--refer", nargs="*",
                   default=["refcoco:unc", "refcocog:umd"],
                   help="dataset:splitby pairs whose val/test images to "
                        "exclude")
    args = p.parse_args(argv)
    roots = [(args.data_root,) + tuple(r.split(":")) for r in args.refer]
    n = make_coco_minus_refer(args.coco_instances, roots, args.out)
    print(f"kept {n} images -> {args.out}")
    return n


if __name__ == "__main__":
    main()
