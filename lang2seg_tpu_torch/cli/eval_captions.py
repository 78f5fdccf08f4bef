"""Caption generation and its metrics.

Counterpart of `lang2seg_tpu/cli/eval_captions.py` (the reference's
caption-metric stack, `pyutils/refer/evaluation/refEvaluation.py`, over
generated expressions): the trained captioner decodes every sentence slot
of a split's images by beam search from the 'res5_2' features (each
slot's image map and its GT-masked copy through layer4), and BLEU-1..4,
ROUGE_L, CIDEr and METEOR score each decode against the slot's own
sentence.

    python -m lang2seg_tpu_torch.cli.eval_captions --variant cycle \\
        --dataset refcoco --split-by unc --id exp0 --splits val

Each slot is keyed by a running index over the split. The JAX package
keys it by its row within one image's batch, so that on a split of more
than one image the last image with a row of that index supplies the
sentence every image's row is scored against; on a one-image split the
two give the same scores. Only the att2in2 captioner decodes
(the other decoders of `models/caption_zoo.py` are teacher-forced only,
as in the JAX package). `--device cpu` runs the plain PyTorch path; the
default is the card.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from . import add_common_flags, open_loader, setup


def score_caption_split(model, loader, split: str, beam_size: int = 10,
                        max_images: int = 0, device="cuda"
                        ) -> Dict[str, float]:
    """The caption metrics of `model`'s beam decodes over a split.

    `model` is a caption variant's `Lang2Seg` (moved to `device`, default
    the card; raises without one); `loader` has `iter_test_batches(split)`
    and `decode_labels` (`data/loader.py::GtBatchLoader`). `max_images`
    > 0 stops after that many images. Returns the metrics by name
    (`Bleu_1`..`Bleu_4`, `ROUGE_L`, `CIDEr`, `METEOR`)."""
    from ..device import resolve_device
    from ..engine.evaluator import _host_expand_bank
    from ..engine.train_captioner import extract_caption_features
    from ..utils.caption_metrics import RefEvaluation

    cap = getattr(model, "caption_model", None)
    if cap is None:
        raise ValueError("score_caption_split: the model has no captioner "
                         "(a caption variant: cycle, cycle_response)")
    if not hasattr(cap, "sample_beam"):
        raise NotImplementedError(
            f"caption model {model.cfg.model.caption_model!r} cannot decode:"
            f" the zoo's decoders other than att2in2 are teacher-forced "
            f"only, as in the JAX package")
    dev = resolve_device(device)
    model = model.to(dev)
    was_training = model.training
    model.eval()
    preds, gt_refs = [], []
    try:
        for bi, batch in enumerate(loader.iter_test_batches(split)):
            if max_images and bi >= max_images:
                break
            # the caption features gate layer4 on each slot's GT mask:
            # expand the ref-deduped mask bank
            batch = _host_expand_bank(batch)
            e = batch["labels"].shape[0]
            fc, att = extract_caption_features(model, {
                "images": torch.as_tensor(batch["images"]).to(dev),
                "gt_masks": torch.as_tensor(batch["gt_masks"]).to(dev),
                "img_idx": torch.zeros((e,), dtype=torch.long, device=dev)})
            seqs, _ = cap.sample_beam(fc, att, beam_size)
            seqs = seqs.cpu().numpy()
            for i in np.flatnonzero(batch["sent_valid"]):
                key = len(preds)
                preds.append({"ref_id": key, "sent": loader.decode_labels(
                    seqs[i][None])[0]})
                gt_refs.append({"ref_id": key, "sentences": [
                    {"sent": loader.decode_labels(
                        batch["labels"][i][None])[0]}]})
    finally:
        model.train(was_training)
    return RefEvaluation(gt_refs, preds).evaluate()


def build_parser():
    p = argparse.ArgumentParser(
        description="lang2seg_tpu_torch caption metrics")
    add_common_flags(p)
    p.set_defaults(variant="cycle")
    p.add_argument("--splits", nargs="+", default=["val"])
    p.add_argument("--beam-size", type=int, default=10)
    p.add_argument("--max-images", type=int, default=0,
                   help="stop after this many images of a split (0: all)")
    p.add_argument("--ckpt-iter", type=int, default=None,
                   help="snapshot iter (default: newest)")
    p.add_argument("--params", default=None,
                   help="score a params file instead of a snapshot: .pth "
                        "(reference keys) or .npz (JAX params); a .pth "
                        "that weights-only loading refuses is unpickled as "
                        "code")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg, tag, prepro_dir, output_dir = setup(args)
    if not cfg.model.use_caption_loss:
        raise SystemExit(f"variant {args.variant!r} has no captioner")

    from ..data.loader import CycleBatchLoader
    from ..engine.checkpoint import CheckpointManager, tolerant_restore
    from ..models.network import build_model

    loader = open_loader(CycleBatchLoader, prepro_dir, cfg)
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
        print("WARNING: no snapshot found, scoring a fresh init")
    results = {}
    for split in args.splits:
        scores = score_caption_split(model, loader, split, args.beam_size,
                                     args.max_images, device=args.device)
        print(f"{tag} {split} " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(scores.items())))
        results[split] = scores
    return results


if __name__ == "__main__":
    main()
