"""Training CLI.

Counterpart of `lang2seg_tpu/cli/train.py` (the reference's per-variant
`tools/train*.py` with `tools/opt.py:4-83`, collapsed into one entry with
`--variant`), on one device:

  python -m lang2seg_tpu_torch.cli.train --variant response \\
      --dataset refcoco --split-by unc --id exp0 --max-iters 600000 \\
      --cfg experiments/res101.yml --set train.learning_rate 1e-4

reads `<prepro-dir>/data.json` and `data.h5` (`python -m
lang2seg_tpu_torch.cli.prepro` writes them) and the images under
`--image-dir`, trains with snapshots under `<output-dir>/ckpt/iter_<n>/`
and resumes from the newest one. `--variant pretrain` trains the plain
Mask R-CNN (no language) over the same REFER batches, each expression's
GT box and mask its one target and its words ignored, as the JAX
package's CLI runs it; `--pretrained` then carries its weights into a
language variant. `--device cpu` runs the plain PyTorch path (a small
config via `--set`); the default is the card.
"""

from __future__ import annotations

import argparse

from . import add_common_flags, open_loader, setup


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lang2seg_tpu_torch trainer")
    add_common_flags(p)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--pretrained", default=None,
                   help=".pth (reference keys) or .npz (JAX params) for "
                        "tolerant transfer init; a .pth that weights-only "
                        "loading refuses is unpickled as code")
    p.add_argument("--captioner-init", default=None,
                   help="captioner model-best.pth (port or reference) or "
                        "model-best.npz (JAX) grafted into the cycle "
                        "variant's captioner")
    p.add_argument("--data-parallel", type=int, default=None, metavar="N",
                   help="data-parallel degree; only 1 is ported")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.data_parallel not in (None, 1):
        raise NotImplementedError(
            "data parallel training is not ported (ROADMAP Queue 1 #5)")
    cfg, _, prepro_dir, output_dir = setup(args)

    from ..data.loader import CycleBatchLoader, GtBatchLoader
    loader = open_loader(CycleBatchLoader if cfg.model.use_caption_loss
                         else GtBatchLoader, prepro_dir, cfg)

    pretrained = None
    if args.pretrained:
        from ..engine.convert import load_params_file
        pretrained = load_params_file(args.pretrained, cfg,
                                      allow_pickle=True)

    from ..engine.trainer import Trainer
    trainer = Trainer(cfg, loader, output_dir, device=args.device)
    if args.captioner_init:
        from ..engine.train_captioner import restore_captioner
        model = trainer.state.model
        model.load_state_dict(restore_captioner(
            model.state_dict(), args.captioner_init, allow_pickle=True))
    losses = trainer.train(max_iters=args.max_iters,
                           load_pretrained=pretrained)
    print("final:", losses)
    return losses


if __name__ == "__main__":
    main()
