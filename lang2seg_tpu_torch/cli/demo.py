"""Visual demo: one image and one expression through the model, saved as an
annotated image (the predicted box and the mask overlay) and the response
map.

Counterpart of `lang2seg_tpu/cli/demo.py` (the reference's
`tools/demo.py`):

  python -m lang2seg_tpu_torch.cli.demo --image path.jpg \\
      --expression "the dog on the left" --prepro-dir cache/prepro/... \\
      --ckpt-dir output/.../ckpt --out demo_out.png

Without --image it runs on a synthetic fixture (RandomState(0) noise,
480 x 640), without --ckpt-dir on random weights (weights.init_params
with cfg.seed), without --prepro-dir on tokens from a stable hash of each
word (crc32; the JAX demo's Python `hash` changes with every process).
`--ckpt-dir` restores the newest snapshot that the port's Trainer wrote
(`<dir>/iter_<n>/state.pth`). The image is resized as the loader resizes
(cv2's INTER_LINEAR rule, `data/loader.py::resize_linear`) and the
output PNGs are written by `utils/visualization.py::write_png`; `--image`
reads through cv2, the one place the demo needs it. The class is printed,
not painted (ROADMAP Queue 3). `--device cpu` runs the plain PyTorch
path; the default is the card.
"""

from __future__ import annotations

import argparse
import os
import zlib
from typing import Dict, List

import numpy as np
import torch

from ..config import VARIANTS, apply_variant, load_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lang2seg_tpu_torch demo")
    p.add_argument("--image", default=None)
    p.add_argument("--expression", default="the object")
    p.add_argument("--variant", default="response", choices=VARIANTS)
    p.add_argument("--prepro-dir", default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--out", default="demo_out.png")
    p.add_argument("--set", dest="overrides", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    return p


def stable_token(word: str, vocab_size: int) -> int:
    """A token id in [1, vocab_size) that is the same in every process."""
    return 1 + zlib.crc32(word.encode("utf-8")) % (vocab_size - 1)


def tokenize(expression: str, cfg, prepro_dir=None) -> List[int]:
    """The expression's token ids: the prepro's vocabulary (unknown words
    to <UNK>; cfg.model.vocab_size follows it) or the stable hash."""
    words = expression.lower().split()
    if prepro_dir:
        from ..data.loader import Loader
        voc = Loader(os.path.join(prepro_dir, "data.json"))
        cfg.model.vocab_size = voc.vocab_size
        unk = voc.word_to_ix.get("<UNK>", 0)
        return [voc.word_to_ix.get(w, unk) for w in words]
    return [stable_token(w, cfg.model.vocab_size) for w in words]


def synthetic_image() -> np.ndarray:
    """The demo's fixture: (480, 640, 3) uint8 noise from RandomState(0)."""
    return (np.random.RandomState(0).rand(480, 640, 3) * 255).astype(np.uint8)


def demo_canvas(im: np.ndarray, cfg):
    """(f32 mean-subtracted canvas (canvas_h, canvas_w, 3), scale, (sh,
    sw)): the image scaled to the test size (600 short side, 1000 long
    side at most, within the canvas) at the canvas' top left."""
    from ..data.loader import resize_linear
    d = cfg.data
    h, w = im.shape[:2]
    scale = min(600.0 / min(h, w), 1000.0 / max(h, w),
                d.canvas_h / h, d.canvas_w / w)
    resized = resize_linear(im, scale)
    resized -= np.asarray(d.pixel_means_bgr, np.float32)
    canvas = np.zeros((d.canvas_h, d.canvas_w, 3), np.float32)
    sh, sw = resized.shape[:2]
    canvas[:sh, :sw] = resized
    return canvas, scale, (sh, sw)


def load_weights(cfg, ckpt_dir=None):
    """The newest snapshot's model state_dict under `ckpt_dir`, or the
    seeded random weights."""
    if ckpt_dir:
        from ..engine.checkpoint import CheckpointManager
        ckpt = CheckpointManager(ckpt_dir)
        it = ckpt.find_previous()
        if it is not None:
            state, _ = ckpt.restore(it)
            print(f"restored iter_{it}")
            return state["model"]
    from ..weights import init_params
    return init_params(cfg, cfg.seed)


def annotate(model, cfg, im: np.ndarray, labels: np.ndarray,
             out_path: str) -> Dict[str, object]:
    """One request of the demo on a built model: the image's canvas and
    the expression's labels (1, T) through `test_forward`, the best class
    over all proposals, its box decoded back to the image, the mask
    pasted and overlaid, the annotated image and the response map written
    as PNGs. Returns the class, the box, the annotated image, the mask
    (None without a mask head) and the two paths."""
    from ..ops.boxes import decode_boxes
    from ..utils.metrics import recover_masks
    from ..utils.visualization import (draw_boxes, save_response_map,
                                       write_png)
    h, w = im.shape[:2]
    canvas, scale, (sh, sw) = demo_canvas(im, cfg)
    dev = next(model.parameters()).device
    out = model.test_forward({
        "images": torch.from_numpy(canvas[None]).to(dev),
        "im_hw": torch.tensor([[sh, sw]], dtype=torch.float32, device=dev),
        "labels": torch.from_numpy(labels).to(dev)})

    scores = out["cls_prob"][0].float().cpu().numpy()
    rois = out["rois"][0].float().cpu().numpy()
    deltas = out["bbox_pred"][0].float().cpu().numpy()
    flat = scores[:, 1:]
    ri, ci = np.unravel_index(np.argmax(flat), flat.shape)
    cls = int(ci) + 1
    pred = decode_boxes(torch.from_numpy(rois / scale),
                        torch.from_numpy(deltas)).numpy()
    box = pred[ri, cls * 4:(cls + 1) * 4]

    vis = draw_boxes(im, box[None], [cls])
    mask = None
    if cfg.model.use_mask_head:
        mp = model.predict_masks(
            out["gated_conv"][:1],
            torch.from_numpy((box * scale)[None, None, :]).to(dev),
            torch.tensor([[cls]], dtype=torch.int64, device=dev))
        mask = recover_masks(mp[0].float().cpu().numpy(), box[None].copy(),
                             h, w)[0]
        overlay = (mask * 255 > 122).astype(np.uint8)
        vis[overlay > 0] = (0.5 * vis[overlay > 0]
                            + 0.5 * np.array([0, 0, 255])).astype(np.uint8)
    out_dir = os.path.dirname(out_path) or "."
    os.makedirs(out_dir, exist_ok=True)
    write_png(out_path, vis)
    resp_path = save_response_map(
        out["response"][0].float().cpu().numpy(), out_dir,
        os.path.splitext(os.path.basename(out_path))[0] + "_response")
    return {"cls": cls, "box": box, "image": vis, "mask": mask,
            "out": out_path, "response": resp_path}


def main(argv=None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)
    from ..data.loader import _cv2_imread
    from ..models.network import build_model

    cfg = load_config(None, args.overrides)
    apply_variant(cfg, args.variant)
    toks = tokenize(args.expression, cfg, args.prepro_dir)[:cfg.data.max_len]
    labels = np.zeros((1, cfg.data.max_len), np.int64)
    labels[0, :len(toks)] = toks
    if args.image:
        im = _cv2_imread(args.image)
        if im is None:
            raise FileNotFoundError(args.image)
    else:
        im = synthetic_image()
    model = build_model(cfg, device=args.device,
                        state_dict=load_weights(cfg, args.ckpt_dir))
    res = annotate(model, cfg, im, labels, args.out)
    print(f"wrote {args.out} (pred class {res['cls']}, box "
          f"{res['box'].round(1)})")
    return res


if __name__ == "__main__":
    main()
