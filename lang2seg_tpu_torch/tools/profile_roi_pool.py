"""The ROI max-pool kernels on the card, at the main path's shapes.

    python -m lang2seg_tpu_torch.tools.profile_roi_pool [--reps 20]
    python -m lang2seg_tpu_torch.tools.profile_roi_pool --routes
        [--baseline PATH]       (PATH: an earlier roi_pool.cu)

Shapes (`SHAPES`): the training crops, 16 x 256 ROIs on (16, 40, 64, C)
bf16 maps gathered from 2 images (C = 512 for MobileNetV1, 1024 for
ResNet-101), forward with its argmax and backward; the serving crops,
16 x 300 ROIs on 16 distinct maps, the gate's per-expression output,
forward without an argmax (a request wants no gradient). The maps are
coarse (multiples of 1/4, and a constant block), so that windows hold
ties; each draw's first and last expression carry `edge_rois` (off the
map, 1 x 1, partly off the map with empty bins, corners on .5 after
scaling, windows of ties) and `OVERSIZE_ROI` (bins too large for a
one-byte argmax code). For each shape: the kernels against the plain
versions of `ops/roi_align.py` (the forward and the decoded argmax bit
for bit, the backward within 1 bf16 ulp) on that draw and on the timed
one (the same without the oversize ROI), then both timed (the kernel by
`profile_nms.device_ms`, the plain version once), each beside its bound
(`roi_pool_bound`, `roi_pool_bwd_bound`) and with its achieved GB/s (the
bound's bytes over the kernel's time) and its slab plan
(`roi_pool_cuda.slab_plan`). `check_shape` also takes a stride-0 map
("broadcast"), and `LARGE_SHAPE` a map past the single-CTA slab (the
forward's global scan, the backward in bands). Prints one JSON line
last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, roi_pool_cuda
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
# a map past the single-CTA slab (120 x 128 = 15360 pixels): the forward's
# "scan" route, the backward's "bands" and two-byte argmax codes; the
# fields of SHAPES
LARGE_SHAPE = ("train_2x64_120x128x48", 2, 64, 120, 128, 48, "gathered",
               True)
# the mask crops' launches on the main paths, (E, ROIs an expression, C)
# on 40 x 64 maps: a box or two an expression (`route_ms`)
CROP_SHAPES = ((1, 1, 512), (4, 1, 512), (4, 2, 512), (8, 1, 512),
               (8, 2, 512), (16, 1, 512), (16, 1, 1024), (16, 2, 512),
               (16, 2, 1024))
# the constant block of the maps, in map cells: (rows, cols)
TIE_BLOCK = (slice(10, 20), slice(10, 30))


def oversize_roi(h: int, w: int) -> torch.Tensor:
    """(4,) an image-coordinate ROI reaching 2000 px beyond an (h, w) map
    at stride 16 on every side: its middle bins cover hundreds of pixels,
    more than a one-byte argmax code counts."""
    return torch.tensor([-2000.0, -2000.0, w * STRIDE + 2000.0,
                         h * STRIDE + 2000.0])


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


def roi_pool_inputs(e, r, h, w, c, maps, dev, dtype=torch.bfloat16, seed=0,
                    oversize=True):
    """(feat (e, h, w, c), rois (e, r, 4) f32, grad (e, r, 7, 7, c)),
    drawn from a seed on the CPU: feat a stride-0 broadcast of one image
    ("broadcast"), gathered from 2 images ("gathered") or one map an
    expression ("distinct"), quantized to multiples of 1/4 with a constant
    block; the first and last expressions' first ROIs the edge cases, then
    `oversize_roi` unless not `oversize` (the inputs of the first kernels'
    timings)."""
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
    edge = edge_rois(h, w)
    if oversize:
        edge = torch.cat([edge, oversize_roi(h, w)[None]])
    edge = edge[:r]
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


def oversize_bins(rois: torch.Tensor, h: int, w: int,
                  code_dtype: torch.dtype) -> int:
    """Bins of these ROIs with more pixels than an argmax code of
    `code_dtype` counts: the backward rescans them in the map."""
    hs, he, ws, we = roi_pool_bins(rois.cpu(), POOLED, SCALE, h, w)
    area = (he - hs).clamp(min=0)[..., :, None] * \
        (we - ws).clamp(min=0)[..., None, :]
    return int((area > torch.iinfo(code_dtype).max).sum())


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


def compare_shape(e, r, h, w, c, maps, dev, train=True, seed=0,
                  dtype=torch.bfloat16, oversize=True):
    """The kernels against the plain versions on one draw: (a dict of the
    errors, the inputs, the codes)."""
    feat, rois, grad = roi_pool_inputs(e, r, h, w, c, maps, dev, dtype,
                                       seed=seed, oversize=oversize)
    out, codes = roi_pool_cuda.roi_pool_forward(feat, rois, POOLED, SCALE)
    bare, none = roi_pool_cuda.roi_pool_forward(feat, rois, POOLED, SCALE,
                                                with_argmax=False)
    torch.cuda.synchronize()
    want = roi_max_pool_plain(feat, rois, POOLED, SCALE)
    want_arg = roi_max_pool_argmax_plain(feat, rois, POOLED, SCALE)
    got_arg = roi_pool_cuda.decode_argmax(codes, rois, POOLED, SCALE, feat)
    torch.cuda.synchronize()
    plan = roi_pool_cuda.slab_plan(h, w, c, dtype, POOLED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {"shape": [e, r, h, w, c], "map": maps,
           "dtype": str(dtype).split(".")[-1],
           "kernel": roi_pool_cuda.forward_kernel(plan, e, r, w, POOLED,
                                                  sms)[0],
           "plan": {"channels": plan["channels"], "slabs": plan["slabs"],
                    "forward": plan["forward"],
                    "backward": plan["backward"],
                    "code": str(plan["code_dtype"]).split(".")[-1]},
           "forward_equal": bool(torch.equal(out, want)
                                 and torch.equal(bare, want)
                                 and none is None),
           "argmax_equal": bool(torch.equal(got_arg, want_arg)),
           "forward_max_abs_err": float(max(
               (out.float() - want.float()).abs().max(),
               (bare.float() - want.float()).abs().max())),
           "empty_bins": int((want_arg < 0).sum()),
           "rescanned_bins": oversize_bins(rois, h, w, codes.dtype),
           "window_pixels": window_pixels(rois, h, w)}
    del want_arg, got_arg, out, bare
    if train:
        d = roi_pool_cuda.roi_pool_backward(grad, codes, feat, rois, POOLED,
                                            SCALE)
        d_want = roi_max_pool_bwd_plain(feat, rois, grad, POOLED, SCALE)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            res["bwd_max_ulps"] = int(bf16_ulp_distance(d, d_want).max())
        else:
            res["bwd_rel_err"] = float((d - d_want).abs().max()
                                       / d_want.abs().max())
        res["bwd_max_abs_err"] = float((d.float() - d_want.float())
                                       .abs().max())
        del d, d_want
    return res, (feat, rois, grad), codes


# the errors of `compare_shape`, each merged over two draws by `merge`
_EQUAL = ("forward_equal", "argmax_equal")
_WORST = ("forward_max_abs_err", "bwd_max_ulps", "bwd_rel_err",
          "bwd_max_abs_err")


def check_shape(name, e, r, h, w, c, maps, train, dev, reps=20, seed=0):
    """One shape: the kernels against the plain versions on two draws, one
    with `oversize_roi` and the inputs of the first kernels' timings (no
    oversize ROI, so that the bounds and times compare with theirs), the
    errors the worse of the two; then both draws timed beside the bounds
    of the second: the forward as the path launches it (with the argmax
    when `train`), the backward when `train` (`*_oversize_ms` on the first
    draw: two of the E expressions hold bins the backward rescans).
    Returns a dict of the numbers."""
    res, (feat_o, rois_o, grad_o), codes_o = compare_shape(
        e, r, h, w, c, maps, dev, train, seed)
    timed, (feat, rois, grad), codes = compare_shape(
        e, r, h, w, c, maps, dev, train, seed, oversize=False)
    for k in _EQUAL:
        res[k] = res[k] and timed[k]
    for k in _WORST:
        if k in res:
            res[k] = max(res[k], timed[k])
    res["name"] = name
    elem = feat.element_size()
    res["ms"] = device_ms(lambda: roi_pool_cuda.roi_pool_forward(
        feat, rois, POOLED, SCALE, with_argmax=train), reps)
    res["oversize_ms"] = device_ms(lambda: roi_pool_cuda.roi_pool_forward(
        feat_o, rois_o, POOLED, SCALE, with_argmax=train), reps)
    res["plain_ms"] = time_ms(lambda: roi_max_pool_plain(
        feat, rois, POOLED, SCALE), 1, warmup=0)
    res["bound_ms"], res["bound_by"], res["bytes"], res["ops"] = \
        roi_pool_bound(rois, h, w, c, elem, maps)
    res["gb_per_s"] = res["bytes"] / res["ms"] / 1e6
    if train:
        res["argmax_bytes"] = codes.numel() * codes.element_size()
        res["bwd_ms"] = device_ms(lambda: roi_pool_cuda.roi_pool_backward(
            grad, codes, feat, rois, POOLED, SCALE), reps)
        res["bwd_oversize_ms"] = device_ms(
            lambda: roi_pool_cuda.roi_pool_backward(
                grad_o, codes_o, feat_o, rois_o, POOLED, SCALE), reps)
        res["bwd_plain_ms"] = time_ms(lambda: roi_max_pool_bwd_plain(
            feat, rois, grad, POOLED, SCALE), 1, warmup=0)
        res["bwd_bound_ms"], res["bwd_bound_by"], res["bwd_bytes"], _ = \
            roi_pool_bwd_bound(rois, h, w, c, elem, maps)
        res["bwd_gb_per_s"] = res["bwd_bytes"] / res["bwd_ms"] / 1e6
    return res


def phase_clocks(e, r, h, w, c, maps, train, dev, seed=0, oversize=False):
    """Where one launch of each kernel spends its time, from the
    -DROI_POOL_PHASE_CLOCKS build: for the forward (as the path launches
    it) and, when `train`, the backward, the CTAs' mean clock64() cycles
    of each phase (forward: the ROIs' rectangle, the slab's load, the
    reduction with its writes; backward: zeroing and the ROIs, the adds,
    the band's write), the launch's span on the globaltimer (first CTA
    start to last CTA end, us), the CTAs' mean duration (us), and the
    backward's cycles in its block-wide rescans, summed over CTAs; on the
    timed inputs, or with `oversize_roi` when `oversize`."""
    feat, rois, grad = roi_pool_inputs(e, r, h, w, c, maps, dev, seed=seed,
                                       oversize=oversize)
    plan = roi_pool_cuda.slab_plan(h, w, c, feat.dtype, POOLED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if roi_pool_cuda.forward_kernel(plan, e, r, w, POOLED, sms)[0] != "slab":
        raise ValueError("phase_clocks times the slab kernels only")
    lib = roi_pool_cuda._bound("roi_pool_clocks")
    lib.roi_pool_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int]
    lib.roi_pool_phase_clocks.restype = ctypes.c_int
    roi_pool_cuda.library = "roi_pool_clocks"
    try:
        _, codes = roi_pool_cuda.roi_pool_forward(feat, rois, POOLED, SCALE,
                                                  with_argmax=train)
        if train:
            roi_pool_cuda.roi_pool_backward(grad, codes, feat, rois, POOLED,
                                            SCALE)
        torch.cuda.synchronize()
    finally:
        roi_pool_cuda.library = "roi_pool"
    grids = {"forward": plan["slabs"] * e,
             "backward": plan["slabs"] * e * plan["backward"]["bands"]}
    names = {"forward": ("rect", "load", "reduce"),
             "backward": ("zero", "adds", "write")}
    out = {}
    for which, kind in enumerate(("forward", "backward")[:1 + bool(train)]):
        n = grids[kind]
        buf = (ctypes.c_longlong * (6 * n))()
        if lib.roi_pool_phase_clocks(buf, which, n) != 0:
            raise RuntimeError("roi_pool phase clocks: read failed")
        v = np.asarray(buf, dtype=np.int64).reshape(n, 6)
        out[kind] = {"ctas": n,
                     **{p: float(v[:, i].mean())
                        for i, p in enumerate(names[kind])},
                     "span_us": float(v[:, 4].max() - v[:, 3].min()) / 1e3,
                     "cta_us": float((v[:, 4] - v[:, 3]).mean()) / 1e3,
                     "rescan_cycles": int(v[:, 5].sum())}
    return out


def route_ms(e, r, h, w, c, maps, dev, routes, rounds=5, reps=20, seed=41):
    """The forward without an argmax (as a request launches it) by each of
    `routes`, {name: fn(feat, rois) -> out}, on one draw: each output
    against the plain version's (bit for bit), then the routes timed in
    turns, `rounds` rounds of `reps` calls each, so that the spread
    between rounds shows beside the gaps between routes. Returns {name:
    {"equal": bool, "ms": [ms a round]}}."""
    feat, rois, _ = roi_pool_inputs(e, r, h, w, c, maps, dev, seed=seed)
    want = roi_max_pool_plain(feat, rois, POOLED, SCALE)
    res = {name: {"equal": bool(torch.equal(fn(feat, rois), want)),
                  "ms": []} for name, fn in routes.items()}
    for _ in range(rounds):
        for name, fn in routes.items():
            res[name]["ms"].append(device_ms(lambda: fn(feat, rois), reps))
    return res


def _route(route, arg):
    """fn(feat, rois) -> out of `roi_pool_cuda.launch_forward` on one
    route, without an argmax."""
    return lambda feat, rois: roi_pool_cuda.launch_forward(
        feat, rois, POOLED, SCALE, route, arg, False)[0]


def _baseline(path):
    """The forward of an earlier roi_pool.cu with the C interface of its
    first version (an int32 argmax, or none), built with the port's flags
    beside its own libraries; returns fn(feat, rois) -> out, launched
    without an argmax."""
    src = Path(path).read_bytes()
    flags = _build._flags("roi_pool")
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = _build.BUILD_DIR / f"baseline-{key}" / "libroi_pool_base.so"
    if not lib_path.exists():
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([_build._nvcc(), *flags, "-o", str(lib_path),
                               str(path)], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"building {path} failed:\n{done.stdout}"
                               f"{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.roi_pool_fwd_launch.argtypes = [p, ctypes.c_longlong, i, i, i, i, i,
                                        p, i, i, ctypes.c_float, p, p, p]
    lib.roi_pool_fwd_launch.restype = i

    def run(feat, rois):
        e, h, w, c = feat.shape
        rois = rois.float().contiguous()
        out = torch.empty((e, rois.shape[1], POOLED, POOLED, c),
                          dtype=feat.dtype, device=feat.device)
        rc = lib.roi_pool_fwd_launch(
            feat.data_ptr(), feat.stride(0), e, h, w, c,
            int(feat.dtype == torch.bfloat16), rois.data_ptr(),
            rois.shape[1], POOLED, SCALE, out.data_ptr(), None,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline roi_pool launch failed: "
                               f"cudaError {rc}")
        return out

    return run


def checks_pass(res) -> bool:
    """The forward and the decoded argmax bit for bit, the backward within
    1 bf16 ulp (1e-6 of its largest magnitude for an f32 map)."""
    return (res["forward_equal"] and res["argmax_equal"]
            and res.get("bwd_max_ulps", 0) <= 1
            and res.get("bwd_rel_err", 0.0) <= 1e-6)


def crop_routes(dev, baseline=None, rounds=7, reps=50):
    """`route_ms` at each of `CROP_SHAPES` on distinct maps: the slab
    kernel (with its `roi_groups`), the global scan, the few-ROI kernel,
    and an earlier roi_pool.cu's forward when `baseline` names its source;
    beside the kernel `roi_pool_cuda.forward_kernel` picks. Returns a list
    of dicts."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    base = _baseline(baseline) if baseline else None
    out = []
    for e, r, c in CROP_SHAPES:
        plan = roi_pool_cuda.slab_plan(40, 64, c, torch.bfloat16, POOLED)
        routes = {"slab": _route(0, roi_pool_cuda.roi_groups(
                      e, r, plan["slabs"], sms)),
                  "scan": _route(1, 1),
                  "few_rois": _route(2, max(roi_pool_cuda.BAND_BYTES
                                            // roi_pool_cuda.SLAB_BYTES, 64))}
        if base is not None:
            routes["baseline"] = base
        res = route_ms(e, r, 40, 64, c, "distinct", dev, routes, rounds,
                       reps)
        out.append({"shape": [e, r, 40, 64, c],
                    "picked": roi_pool_cuda.forward_kernel(
                        plan, e, r, 64, POOLED, sms)[0], **res})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--routes", action="store_true",
                    help="time the forward's kernels against each other at "
                         "the mask crops' shapes (`crop_routes`) instead")
    ap.add_argument("--baseline", default=None,
                    help="with --routes: an earlier roi_pool.cu to time "
                         "beside them")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_roi_pool needs a CUDA device")
    dev = torch.device("cuda")
    if args.routes:
        results = crop_routes(dev, args.baseline)
        for res in results:
            print(json.dumps(res), flush=True)
        ok = all(v["equal"] for res in results for k, v in res.items()
                 if isinstance(v, dict))
        print(json.dumps({"device": torch.cuda.get_device_name(0), "ok": ok}))
        if not ok:
            raise SystemExit(1)
        return
    results = []
    for shape in SHAPES + (LARGE_SHAPE,):
        res = check_shape(*shape, dev, reps=args.reps)
        print(json.dumps(res), flush=True)
        results.append(res)
    ok = all(checks_pass(r) for r in results)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ok": ok,
                      "shapes": results}))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
