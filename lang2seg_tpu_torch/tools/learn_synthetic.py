"""Closed-loop learning proof: train a small config from scratch on the
fixed learnable synthetic set (`data/synthetic.py::
synthetic_learnable_set`), then score it through the real eval protocol
(`Evaluator.eval_split`; reference model/test.py:185-450). Det acc and
overall IoU must rise from about 0 to high. The counterpart of the JAX
package's `experiments/learn_synthetic.py`, with its flags and its
`--json` last line; `chip_smoke.py` phase 13 runs it with the settings
of `tests/test_learning.py` and holds it to that test's bounds.

    python -m lang2seg_tpu_torch.tools.learn_synthetic --steps 600 \\
        --lr 2e-4 --decay-at 450 --eval-every 200 --json [--cpu]

f32 maps run with TF32 off. The step is `train_step` over the one fixed
batch (no Trainer, no loader).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import torch

from ..config import Config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--images", type=int, default=4)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--gate", default="sigmoid",
                    choices=["multiply", "sigmoid"])
    ap.add_argument("--filters", type=int, default=1)
    ap.add_argument("--response-loss", action="store_true", default=True)
    ap.add_argument("--no-response-loss", dest="response_loss",
                    action="store_false")
    ap.add_argument("--num-classes", type=int, default=8)
    ap.add_argument("--decay-at", type=int, default=0,
                    help="step at which the LR decays x0.1 (0 = never)")
    ap.add_argument("--backbone", default="resnet26")
    ap.add_argument("--canvas", default="128x192",
                    help="HxW canvas; the set's rectangles scale with it")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--json", action="store_true",
                    help="print one final JSON line (untrained and "
                         "trained summaries)")
    return ap


def build_config(args) -> Config:
    """The config of the JAX harness for these flags."""
    cfg = Config()
    ch, cw = (int(x) for x in args.canvas.split("x"))
    cfg.data.canvas_h, cfg.data.canvas_w = ch, cw
    cfg.data.max_orig_h, cfg.data.max_orig_w = ch, cw
    m, t = cfg.model, cfg.train
    m.backbone = args.backbone
    m.vocab_size = 16
    m.compute_dtype = args.dtype
    m.normalize_response = True
    m.num_filters = args.filters
    m.response_gate = args.gate
    m.use_response_loss = args.response_loss
    m.num_classes = args.num_classes
    t.learning_rate = args.lr
    t.grad_clip_norm = 10.0
    t.rpn_pre_nms_top_n = 512
    t.rpn_post_nms_top_n = 128
    t.roi_batch_size = 32
    t.stepsize = (args.decay_at or 10 ** 9,)
    cfg.test.rpn_pre_nms_top_n = 256
    cfg.test.rpn_post_nms_top_n = 32
    return cfg


def run(argv: Optional[List[str]] = None) -> Dict:
    """Train and score; returns {"untrained", "trained": summaries,
    "steps", "history": [(step, loss, det_acc, iou)], "train_seconds",
    "eval_seconds"}."""
    from ..data.synthetic import synthetic_learnable_set
    from ..engine.evaluator import Evaluator
    from ..engine.train_state import create_train_state, to_device, \
        train_step

    args = build_parser().parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = build_config(args)
    train_batch, eval_batches = synthetic_learnable_set(cfg, args.images,
                                                        seed=0)
    state = create_train_state(cfg, device, seed=0)
    ev = Evaluator(state.model, cfg, device=device)
    state.model.train()
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    # one device: the uid-keyed draws of the JAX step are plain draws here
    batch = to_device({k: v for k, v in train_batch.items()
                       if k != "expr_uid"}, device)

    t_eval = time.perf_counter()
    s0 = ev.eval_split(eval_batches)
    eval_seconds = time.perf_counter() - t_eval
    print(f"untrained: det_acc={s0['det_acc']:.3f} "
          f"iou={s0['overall_iou']:.3f}", flush=True)
    history, train_seconds = [], 0.0
    t0 = time.perf_counter()
    for it in range(1, args.steps + 1):
        losses = train_step(state, batch, generator)
        if it % args.eval_every == 0 or it == args.steps:
            tot = float(losses["total_loss"])
            train_seconds += time.perf_counter() - t0
            s = ev.eval_split(eval_batches)
            history.append((it, tot, s["det_acc"], s["overall_iou"]))
            print(f"step {it}: loss={tot:.3f} det_acc={s['det_acc']:.3f} "
                  f"iou={s['overall_iou']:.3f} ({train_seconds:.1f} s "
                  f"training)", flush=True)
            if tot != tot:
                raise FloatingPointError(f"NaN loss at step {it}")
            t0 = time.perf_counter()
    s1 = ev.eval_split(eval_batches)
    out = {"untrained": s0, "trained": s1, "steps": args.steps,
           "history": history, "train_seconds": train_seconds,
           "eval_seconds": eval_seconds}
    if args.json:
        print(json.dumps({"untrained": s0, "trained": s1,
                          "steps": args.steps}), flush=True)
    return out


if __name__ == "__main__":
    run()
