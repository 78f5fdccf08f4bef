"""Training CLI.

Counterpart of `lang2seg_tpu/cli/train.py` (the reference's per-variant
`tools/train*.py` with `tools/opt.py:4-83`, collapsed into one entry with
`--variant`):

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

Data parallel: `--data-parallel N` (0: every local card) trains on N
ranks, one process each, under torchrun:

  torchrun --nproc-per-node N -m lang2seg_tpu_torch.cli.train \
      --data-parallel N --variant response ...

each rank on card LOCAL_RANK over NCCL (with `--device cpu`, gloo), each
taking its own block of every batch; rank 0 alone prints and writes the
event log and the snapshots.
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
                   help="data-parallel degree: N ranks under torchrun "
                        "(0 = every local card; default: "
                        "cfg.parallel.num_data)")
    return p


def _data_parallel(args, cfg):
    """The rank's Mesh when the run is data parallel (None otherwise):
    the process group from torchrun's environment, its size checked
    against --data-parallel (0: the local cards)."""
    n = args.data_parallel
    if n is None:
        n = cfg.parallel.num_data
    elif n == 0:
        import torch
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("--data-parallel 0 counts the local cards, "
                               "and there is none")
    if n <= 1:
        return None
    from ..parallel.mesh import initialize_multihost
    mesh = initialize_multihost(device=args.device)
    if mesh.size != n:
        raise ValueError(f"--data-parallel {n} but torchrun started "
                         f"{mesh.size} ranks (--nproc-per-node)")
    cfg.parallel.num_data = n
    return mesh


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg, _, prepro_dir, output_dir = setup(args)
    mesh = _data_parallel(args, cfg)

    from ..data.loader import CycleBatchLoader, GtBatchLoader
    loader = open_loader(CycleBatchLoader if cfg.model.use_caption_loss
                         else GtBatchLoader, prepro_dir, cfg)

    pretrained = None
    if args.pretrained:
        from ..engine.convert import load_params_file
        pretrained = load_params_file(args.pretrained, cfg,
                                      allow_pickle=True)

    from ..engine.trainer import Trainer
    trainer = Trainer(cfg, loader, output_dir, device=args.device,
                      mesh=mesh)
    if args.captioner_init:
        from ..engine.train_captioner import restore_captioner
        model = trainer.state.model
        model.load_state_dict(restore_captioner(
            model.state_dict(), args.captioner_init, allow_pickle=True))
    losses = trainer.train(max_iters=args.max_iters,
                           load_pretrained=pretrained)
    if trainer.is_main:
        print("final:", losses)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return losses


if __name__ == "__main__":
    main()
