"""The ROI max-pool kernels on the card, at the main path's shapes.

    python -m lang2seg_tpu_torch.tools.profile_roi_pool [--reps 20]

Shapes (`SHAPES`): the training crops, 16 x 256 ROIs on (16, 40, 64, C)
bf16 maps gathered from 2 images (C = 512 for MobileNetV1, 1024 for
ResNet-101), forward with its argmax and backward; the serving crops,
16 x 300 ROIs on 16 distinct maps, the gate's per-expression output,
forward without an argmax (a request wants no gradient). The maps are
coarse (multiples of 1/4, and a constant block), so that windows hold
ties; each draw's first and last expression carry `edge_rois` (off the
map, 1 x 1, partly off the map with empty bins, corners on .5 after
scaling, windows of ties). For each shape: the kernel against the plain
version of `ops/roi_align.py` (forward and argmax bit for bit, backward
within 1 bf16 ulp), then both timed (the kernel by
`profile_nms.device_ms`, the plain version once), each beside its bound
(`roi_pool_bound`, `roi_pool_bwd_bound`). `check_shape` also takes a
stride-0 map ("broadcast"), which the kernel supports. Prints one JSON
line last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import roi_pool_cuda
from ..ops.roi_align import (roi_max_pool_argmax_plain,
                             roi_max_pool_bwd_plain, roi_max_pool_plain,
                             roi_pool_bins)
from .profile_gate import bf16_ulp_distance
from .profile_nms import F32_FLOPS, HBM_BYTES_PER_S, device_ms, time_ms

POOLED = 7
SCALE = 1.0 / 16
STRIDE = 16
# (name, expressions, ROIs an expression, H, W, C, maps, training): maps
# "gathered" is a map per expression drawn from 2 images, "distinct" one
# drawn per expression, "broadcast" one image's map read in place by every
# expression (stride 0); a training shape's forward writes the argmax and
# its backward is checked and timed
SHAPES = (("train_16x256_40x64x512", 16, 256, 40, 64, 512, "gathered", True),
          ("train_16x256_40x64x1024", 16, 256, 40, 64, 1024, "gathered",
           True),
          ("serve_16x300_40x64x512", 16, 300, 40, 64, 512, "distinct", False),
          ("serve_16x300_40x64x1024", 16, 300, 40, 64, 1024, "distinct",
           False))
# the constant block of the maps, in map cells: (rows, cols)
TIE_BLOCK = (slice(10, 20), slice(10, 30))


def edge_rois(h: int, w: int) -> torch.Tensor:
    """(12, 4) image-coordinate ROIs of the edge cases on an (h, w) map at
    stride 16."""
    ih, iw = float(h * STRIDE), float(w * STRIDE)
    return torch.tensor([
        [-300.0, -200.0, -40.0, -24.0],       # off the map: every bin empty
        [iw + 50.0, ih + 50.0, iw + 400.0, ih + 300.0],   # off, below right
        [130.0, 70.0, 130.0, 70.0],           # 1 x 1
        [8.0, 24.0, 40.0, 56.0],              # corners 0.5, 1.5, 2.5, 3.5
        [24.0, 40.0, 24.0, 40.0],             # 1 x 1 on .5 corners
        [40.0, 40.0, 72.0, 88.0],             # corners 2.5, 4.5, 5.5
        [-8.0, -8.0, 8.0, 8.0],               # corners -0.5 and 0.5
        [0.0, 0.0, iw - 1.0, ih - 1.0],       # the whole map
        [iw - 40.0, ih - 40.0, iw + 200.0, ih + 200.0],   # empty bins
        [160.0, 160.0, 479.0, 319.0],         # the constant block: all ties
        [192.0, 176.0, 224.0, 208.0],         # inside the constant block
        [3.0, 5.0, 1000.0, 9.0],              # one row high, many wide
    ], dtype=torch.float32)


def proposals(e: int, r: int, h: int, w: int, g: torch.Generator
              ) -> torch.Tensor:
    """(e, r, 4) boxes inside the (h * 16, w * 16) image: centres
    uniform, sizes log-uniform over 8-512 px, aspect ratios over 1/2-2."""
    ih, iw = h * STRIDE, w * STRIDE
    cx = torch.rand((e, r), generator=g) * iw
    cy = torch.rand((e, r), generator=g) * ih
    size = torch.exp(torch.empty((e, r)).uniform_(np.log(8.0), np.log(512.0),
                                                  generator=g))
    ratio = torch.exp(torch.empty((e, r)).uniform_(np.log(0.5), np.log(2.0),
                                                   generator=g))
    bw, bh = size * ratio.sqrt(), size / ratio.sqrt()
    return torch.stack([(cx - bw / 2).clamp(0, iw - 1),
                        (cy - bh / 2).clamp(0, ih - 1),
                        (cx + bw / 2).clamp(0, iw - 1),
                        (cy + bh / 2).clamp(0, ih - 1)], -1)


def roi_pool_inputs(e, r, h, w, c, maps, dev, dtype=torch.bfloat16, seed=0):
    """(feat (e, h, w, c), rois (e, r, 4) f32, grad (e, r, 7, 7, c)),
    drawn from a seed on the CPU: feat a stride-0 broadcast of one image
    ("broadcast"), gathered from 2 images ("gathered") or one map an
    expression ("distinct"), quantized to multiples of 1/4 with a constant
    block; the first and last expressions' first ROIs the edge cases."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_img = {"broadcast": 1, "gathered": 2, "distinct": e}[maps]
    img = torch.round(torch.randn((n_img, h, w, c), generator=g) * 4.0) / 4.0
    img[:, TIE_BLOCK[0], TIE_BLOCK[1]] = 1.0
    img = img.to(dev, dtype)
    if maps == "broadcast":
        feat = img.expand(e, h, w, c)
    elif maps == "gathered":
        feat = img[(torch.arange(e) % 2).to(dev)]
    else:
        feat = img
    rois = proposals(e, r, h, w, g)
    edge = edge_rois(h, w)[:r]
    rois[0, :len(edge)] = edge
    rois[-1, :len(edge)] = edge
    grad = torch.randn((e, r, POOLED, POOLED, c), generator=g).to(dev, dtype)
    return feat, rois.to(dev), grad


def _bound(byts, ops):
    b_bytes, b_ops = byts / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return (max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops
            else "operations", byts, ops)


def window_pixels(rois: torch.Tensor, h: int, w: int) -> int:
    """Pixels in all bins of these ROIs (what a scan must compare)."""
    hs, he, ws, we = roi_pool_bins(rois.cpu(), POOLED, SCALE, h, w)
    rows = (he - hs).clamp(min=0)[..., :, None]
    cols = (we - ws).clamp(min=0)[..., None, :]
    return int((rows * cols).sum())


def map_pixels(rois: torch.Tensor, h: int, w: int, maps: str) -> int:
    """Map pixels a function of these ROIs must read: the union of each
    map's windows (a ROI's bins tile its clipped rectangle), over one map
    for a stride-0 map, else summed over the E maps."""
    hs, he, ws, we = roi_pool_bins(rois.cpu(), POOLED, SCALE, h, w)
    ys, xs = torch.arange(h), torch.arange(w)
    rows = (ys >= hs[..., :1]) & (ys < he[..., -1:])             # (E, R, H)
    cols = (xs >= ws[..., :1]) & (xs < we[..., -1:])             # (E, R, W)
    covered = (rows[..., :, None] & cols[..., None, :]).any(1)   # (E, H, W)
    if maps == "broadcast":
        covered = covered.any(0)
    return int(covered.sum())


def roi_pool_bound(rois, h, w, c, elem, maps):
    """(bound ms, 'bytes' or 'operations', bytes, ops) of the forward on
    these ROIs: the maps' pixels under some window read once
    (`map_pixels`), the ROIs read, the outputs written (an argmax is the
    kernel's choice for the backward, not the function's: the JAX
    formulation stores none); one compare a window pixel and channel."""
    e, r = rois.shape[:2]
    out = e * r * POOLED * POOLED * c
    byts = map_pixels(rois, h, w, maps) * c * elem + e * r * 16 + out * elem
    return _bound(byts, window_pixels(rois, h, w) * c)


def roi_pool_bwd_bound(rois, h, w, c, elem, maps):
    """The same for the backward, as the JAX package's VJP computes it
    from (map, ROIs, gradient): the gradient, the maps' pixels under some
    window and the ROIs read, the maps' gradient written in full; one add
    an output (the kernel reads the forward's int32 argmax instead of the
    maps)."""
    e, r = rois.shape[:2]
    out = e * r * POOLED * POOLED * c
    byts = (out * elem + map_pixels(rois, h, w, maps) * c * elem + e * r * 16
            + e * h * w * c * elem)
    return _bound(byts, out)


def compare_shape(e, r, h, w, c, maps, dev, train=True, seed=0):
    """The kernels against the plain versions on one draw: (a dict of the
    errors, the inputs, the argmax)."""
    feat, rois, grad = roi_pool_inputs(e, r, h, w, c, maps, dev, seed=seed)
    out, argmax = roi_pool_cuda.roi_pool_forward(feat, rois, POOLED, SCALE)
    bare, none = roi_pool_cuda.roi_pool_forward(feat, rois, POOLED, SCALE,
                                                with_argmax=False)
    torch.cuda.synchronize()
    want = roi_max_pool_plain(feat, rois, POOLED, SCALE)
    want_arg = roi_max_pool_argmax_plain(feat, rois, POOLED, SCALE)
    torch.cuda.synchronize()
    res = {"shape": [e, r, h, w, c], "map": maps,
           "forward_equal": bool(torch.equal(out, want)
                                 and torch.equal(bare, want)
                                 and none is None),
           "argmax_equal": bool(torch.equal(argmax.long(), want_arg)),
           "forward_max_abs_err": float(max(
               (out.float() - want.float()).abs().max(),
               (bare.float() - want.float()).abs().max())),
           "empty_bins": int((argmax < 0).sum()),
           "window_pixels": window_pixels(rois, h, w)}
    del want_arg, out, bare
    if train:
        d = roi_pool_cuda.roi_pool_backward(grad, argmax, tuple(feat.shape),
                                            feat.dtype)
        d_want = roi_max_pool_bwd_plain(feat, rois, grad, POOLED, SCALE)
        torch.cuda.synchronize()
        res["bwd_max_ulps"] = int(bf16_ulp_distance(d, d_want).max())
        res["bwd_max_abs_err"] = float((d.float() - d_want.float())
                                       .abs().max())
        del d, d_want
    return res, (feat, rois, grad), argmax


def check_shape(name, e, r, h, w, c, maps, train, dev, reps=20, seed=0):
    """One shape: the kernels against the plain versions (errors), then
    timed beside their bounds: the forward as the path launches it (with
    the argmax when `train`), the backward when `train`. Returns a dict
    of the numbers."""
    res, (feat, rois, grad), argmax = compare_shape(e, r, h, w, c, maps, dev,
                                                    train, seed)
    res["name"] = name
    elem = feat.element_size()
    fwd = lambda: roi_pool_cuda.roi_pool_forward(feat, rois, POOLED, SCALE,
                                                 with_argmax=train)
    res["ms"] = device_ms(fwd, reps)
    res["plain_ms"] = time_ms(lambda: roi_max_pool_plain(
        feat, rois, POOLED, SCALE), 1, warmup=0)
    res["bound_ms"], res["bound_by"], res["bytes"], res["ops"] = \
        roi_pool_bound(rois, h, w, c, elem, maps)
    if train:
        res["argmax_bytes"] = e * r * POOLED * POOLED * c * 4
        bwd = lambda: roi_pool_cuda.roi_pool_backward(
            grad, argmax, tuple(feat.shape), feat.dtype)
        res["bwd_ms"] = device_ms(bwd, reps)
        res["bwd_plain_ms"] = time_ms(lambda: roi_max_pool_bwd_plain(
            feat, rois, grad, POOLED, SCALE), 1, warmup=0)
        res["bwd_bound_ms"], res["bwd_bound_by"], res["bwd_bytes"], _ = \
            roi_pool_bwd_bound(rois, h, w, c, elem, maps)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_roi_pool needs a CUDA device")
    dev = torch.device("cuda")
    results = []
    for shape in SHAPES:
        res = check_shape(*shape, dev, reps=args.reps)
        print(json.dumps(res), flush=True)
        results.append(res)
    ok = all(r["forward_equal"] and r["argmax_equal"]
             and r.get("bwd_max_ulps", 0) <= 1 for r in results)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ok": ok,
                      "shapes": results}))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
