"""Evaluation CLI.

Counterpart of `lang2seg_tpu/cli/eval.py` (reference `tools/eval*.py` +
`experiments/scripts/eval_*.sh`): restore a snapshot (the newest under
`<output-dir>/ckpt`, or `--ckpt-iter`) or a params file (`--params`),
score each split with `Evaluator.eval_split` (sentences padded to the
smallest fitting bucket, masks as the ref-deduped bank), print det acc,
seg Prec@X and overall IoU, and append the line to
`<output-dir>/det_results.txt` and, with a mask head, `mask_results.txt`
(tools/eval.py:97-125). `--reference-exact` scores with the reference's
own metric chain on the host (loader GT masks included), `--host-paste`
pastes the masks back on the host. `--images-per-dispatch N` scores N
images of a sentence bucket in one dispatch; the extent-crop wire follows
cfg.data.wire_extent_crop (`--set data.wire_extent_crop false` turns it
off). `--device cpu` runs the plain PyTorch path; the default is the card.
"""

from __future__ import annotations

import argparse
import os

from . import add_common_flags, open_loader, setup


def build_parser():
    p = argparse.ArgumentParser(description="lang2seg_tpu_torch evaluator")
    add_common_flags(p)
    p.add_argument("--splits", nargs="+", default=["val"])
    p.add_argument("--ckpt-iter", type=int, default=None,
                   help="snapshot iter (default: newest)")
    p.add_argument("--params", default=None,
                   help="evaluate a params file instead of a snapshot: "
                        ".pth (reference keys) or .npz (JAX params), "
                        "applied with the tolerant restore; a .pth that "
                        "weights-only loading refuses is unpickled as code")
    p.add_argument("--max-sents", type=int, default=32)
    p.add_argument("--sent-buckets", type=int, nargs="*",
                   default=[8, 16, 32],
                   help="pad each image to the smallest fitting bucket "
                        "instead of max-sents; nothing after the flag "
                        "disables it")
    p.add_argument("--images-per-dispatch", type=int, default=1,
                   help="score N images of one sentence bucket in one "
                        "dispatch (fewer, larger launches; 1 = per image)")
    p.add_argument("--reference-exact", action="store_true",
                   help="the reference's metric chain on the host: the "
                        "bytescale + bilinear paste-back cut at > 122 and "
                        "Pillow-NEAREST GT masks, in the loader too")
    p.add_argument("--host-paste", action="store_true",
                   help="paste the masks back on the host (recover_masks "
                        "and nearest_resize) instead of the device")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg, tag, prepro_dir, output_dir = setup(args)
    if args.reference_exact:
        cfg.data.reference_exact_masks = True

    from ..data.loader import GtBatchLoader
    loader = open_loader(GtBatchLoader, prepro_dir, cfg)

    from ..engine.checkpoint import CheckpointManager, tolerant_restore
    from ..engine.evaluator import Evaluator
    from ..models.network import build_model

    model = build_model(cfg, device=args.device)
    ckpt = CheckpointManager(os.path.join(output_dir, "ckpt"))
    it = args.ckpt_iter or (None if args.params else ckpt.find_previous())
    if args.params:
        from ..engine.convert import load_params_file
        merged, skipped = tolerant_restore(
            model.state_dict(),
            load_params_file(args.params, cfg, allow_pickle=True))
        model.load_state_dict(merged)
        print(f"restored params file {args.params} (skipped "
              f"{ {k: len(v) for k, v in skipped.items()} })")
    elif it is not None:
        state, _ = ckpt.restore(
            it, map_location=next(model.parameters()).device)
        model.load_state_dict(state["model"])
        print(f"restored snapshot iter_{it}")
    else:
        print("WARNING: no snapshot found, evaluating fresh init")

    evaluator = Evaluator(model, cfg, device=args.device,
                          device_paste=not args.host_paste,
                          reference_exact=args.reference_exact)
    results = {}
    for split in args.splits:
        res = evaluator.eval_split(
            loader.iter_test_batches(
                split, args.max_sents,
                buckets=tuple(args.sent_buckets) or None),
            verbose=True, images_per_dispatch=args.images_per_dispatch)
        line = (f"{tag} {args.variant}_{args.id} iter={it} split={split} "
                + " ".join(f"{k}={v:.4f}" for k, v in sorted(res.items())))
        print(line)
        os.makedirs(output_dir, exist_ok=True)
        names = ("det_results.txt",) + (
            ("mask_results.txt",) if cfg.model.use_mask_head else ())
        for name in names:
            with open(os.path.join(output_dir, name), "a") as f:
                f.write(line + "\n")
        results[split] = res
    return results


if __name__ == "__main__":
    main()
