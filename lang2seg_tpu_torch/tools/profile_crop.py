"""The ROI crop kernels on the card, at the main path's shapes.

    python -m lang2seg_tpu_torch.tools.profile_crop [--reps 20]
        [--baseline PATH]       (PATH: an earlier roi_crop.cu)

Shapes (`SHAPES`, then `TOP_SHAPE`): the serving crops, 16 x 300 ROIs on
16 distinct (16, 40, 64, 1024) bf16 maps (the gate's per-expression
output); the training crops, 16 x 256 ROIs on maps gathered from 2
images at C = 1024 (`response`, `cycle_response`) and C = 512 (`vgg`),
forward and backward; the mask crops, 16 x 2; the attribute crops, 16 x 1
on gathered maps, forward and backward; test mode 'top' at E = 16, 16 x
5000 ROIs. Each draw's first and last expression carry `edge_rois` (off
the map, partly off, zero width or height, samples on integral
coordinates, the whole map, a ROI far wider than the map). For each
shape: the forward kernel against `crop_gather_plain` (its own algorithm
in torch ops: the same bits) and the plain version (the einsum pair of
`ops/roi_align.py`; at 'top' both in chunks of ROIs, whose intermediate
would need 46 GB whole), within `FWD_ULPS`; the backward kernel against
`crop_bwd_coords_plain` (its fixed-order algorithm in torch ops: the same
bits), against autograd of the einsum pair (within `BWD_ULPS`), and
against itself on a second run (the same bits).
Then each is timed (the kernel by `profile_nms.device_ms`; the plain
version and `library_ms`, one `F.grid_sample` call of the same function
forward and its backward, by CUDA events) beside its bound (`crop_bound`,
`crop_bwd_bound`) and, as yardsticks of the card's memory, a fill and a
copy of a tensor of the crops' size (`fill_ms`, `copy_ms`). `--baseline`
builds an earlier roi_crop.cu with the port's flags and times its two C
entries beside this source's, in turns on the same inputs, at `SHAPES`,
`TOP_SHAPE` and `MAIN_PATH_EXTRA` (every other shape the main path crops
at), the outputs compared bit for bit. Prints one JSON line a shape and a
last one with all of them. Needs a CUDA device.
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
import torch.nn.functional as F

from ..ops import _build, roi_crop_cuda
from ..ops.roi_align import (_sample_coords, _taps, crop_and_resize_plain,
                             crop_bwd_coords_plain, crop_gather_plain)
from .profile_gate import bf16_ulp_distance
from .profile_nms import F32_FLOPS, HBM_BYTES_PER_S, device_ms, time_ms
from .profile_roi_pool import proposals

S = 7
SCALE = 1.0 / 16
STRIDE = 16
# (name, expressions, ROIs an expression, H, W, C, maps, training): maps
# "gathered" is a map per expression drawn from 2 images, "distinct" one
# drawn per expression, "broadcast" one image's map read in place by every
# expression (stride 0); a training shape's backward is checked and timed
SHAPES = (("serve_16x300_40x64x1024", 16, 300, 40, 64, 1024, "distinct",
           False),
          ("train_16x256_40x64x1024", 16, 256, 40, 64, 1024, "gathered",
           True),
          ("train_16x256_40x64x512", 16, 256, 40, 64, 512, "gathered", True),
          ("masks_16x2_40x64x1024", 16, 2, 40, 64, 1024, "distinct", False),
          ("att_16x1_40x64x1024", 16, 1, 40, 64, 1024, "gathered", True))
TOP_SHAPE = ("top_16x5000_40x64x1024", 16, 5000, 40, 64, 1024, "distinct",
             False)
# the other shapes the main path crops at (`chip_smoke.py`'s `kernels`
# line), for `--baseline`: (expressions, ROIs, H, W, C, dtype, training):
# eval and serving at 1-128 expressions, the mask crops, comprehension, the
# demo, `vgg` serving (C = 512), `pretrain` (2 x 256, trained), 'top' at E
# = 2, and the tiny f32 steps of the learning proof and the card-vs-CPU
# checks on 8 x 12 maps
MAIN_PATH_EXTRA = tuple(
    [(e, r, 40, 64, 1024, torch.bfloat16, False) for e, r in (
        (1, 1), (1, 16), (1, 300), (2, 1), (4, 1), (4, 2), (4, 300),
        (8, 1), (8, 2), (8, 300), (16, 3), (16, 32), (32, 1), (32, 6),
        (32, 32), (32, 300), (64, 1), (64, 300), (128, 1), (128, 300),
        (2, 5000))]
    + [(2, 256, 40, 64, 1024, torch.bfloat16, True)]
    + [(e, 300, 40, 64, 512, torch.bfloat16, False) for e in (4, 8, 16)]
    + [(e, r, 8, 12, 1024, torch.float32, train) for e, r, train in (
        (2, 1, False), (2, 32, True), (3, 1, False), (3, 32, False),
        (4, 1, True), (4, 32, True), (8, 32, True))]
    + [(4, 32, 8, 12, 512, torch.float32, True)])
# (expression, ROI) pairs a chunk of the plain version at most, where its
# (E, R, H, S, C) intermediate (4.6 GB at 8000 pairs of a 40-row,
# 1024-channel bf16 map) would not fit whole
PLAIN_PAIRS = 8000
# the largest forward error allowed against the einsum pair, in bf16
# ulps at the scale of the same crop of |feat| (`ulps_at`): each einsum on
# the card is a tensor-core sum of the two exact products, which may round
# otherwise than one f32 sum where they nearly cancel, so that a row of the
# x pass rounds to the neighbouring bf16 value: 1 ulp at the row's scale,
# which its y weight w carries into the output as at most 2 ulps at the
# scale w * row (w * ulp(a) <= 2 ulp(w * a)), and 1 more where the output's
# own rounding flips with it; f32 maps within 1e-6 of the largest value.
# Against `crop_gather_plain`, the kernel's algorithm, the same bits.
FWD_ULPS = 3.0
FWD_F32_REL = 1e-6
# the backward against autograd of the einsum pair: bf16 ulps at the scale
# of the same backward of |grad|: 1 for the final rounding, and 1 for each
# of up to two of the einsum's rounded (R, H, S) intermediates that its
# tensor-core sum rounds the other way in the same element; f32 within
# 1e-5 of the largest value. Against `crop_bwd_coords_plain`, the same
# bits.
BWD_ULPS = 3.0
BWD_F32_REL = 1e-5
# f32 operations an output: two rows of two x taps (4 multiply-adds), two
# y taps (2 more)
OPS_PER_OUTPUT = 12


def edge_rois(h: int, w: int) -> torch.Tensor:
    """(10, 4) image-coordinate ROIs of the edge cases on an (h, w) map at
    stride 16."""
    ih, iw = float(h * STRIDE), float(w * STRIDE)
    return torch.tensor([
        [-300.0, -200.0, -40.0, -24.0],       # off the map
        [iw + 50.0, ih + 50.0, iw + 400.0, ih + 300.0],   # off, below right
        [-40.0, -24.0, 200.0, 150.0],         # partly off, top left
        [96.0, 64.0, 96.0, 300.0],            # zero width
        [32.0, 80.0, 400.0, 80.0],            # zero height
        [0.0, 0.0, 96.0, 192.0],              # samples on integers
        [0.0, 0.0, iw - 16.0, ih - 16.0],     # the whole map, on integers
        [iw - 40.0, ih - 40.0, iw + 200.0, ih + 200.0],   # past the corner
        [-2000.0, 100.0, iw + 2000.0, 180.0],  # far wider than the map
        [130.0, 70.0, 133.0, 71.0],           # inside one cell
    ], dtype=torch.float32)


def crop_inputs(e, r, h, w, c, maps, dev, dtype=torch.bfloat16, seed=0,
                s=S, with_grad=True):
    """(feat (e, h, w, c), rois (e, r, 4) f32, grad (e, r, s, s, c), None
    unless `with_grad`), drawn from a seed on the CPU: feat a stride-0
    broadcast of one image ("broadcast"), gathered from 2 images
    ("gathered") or one map an expression ("distinct"); the first and
    last expressions' first ROIs the edge cases."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_img = {"broadcast": 1, "gathered": 2, "distinct": e}[maps]
    img = torch.randn((n_img, h, w, c), generator=g).to(dev, dtype)
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
    grad = torch.randn((e, r, s, s, c), generator=g).to(dev, dtype) \
        if with_grad else None
    return feat, rois.to(dev), grad


def coords(rois: torch.Tensor, s: int = S):
    """The (E, R, S) sample coordinates both routes read."""
    ys, xs = _sample_coords(rois.float(), s, SCALE)
    return ys.contiguous(), xs.contiguous()


def _bound(byts, ops):
    b_bytes, b_ops = byts / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return (max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops
            else "operations", byts, ops)


def _touched(cs: torch.Tensor, n: int) -> torch.Tensor:
    """(E, R, n): the cells of an axis of n under some tap of (E, R, S)
    sample coordinates with a weight that is not zero."""
    hit = torch.zeros(cs.shape[:2] + (n,), dtype=torch.int64)
    for idx, weight in _taps(cs, n, torch.float32):
        hit.scatter_add_(2, idx, (weight > 0).long())
    return hit > 0


def tap_pixels(rois: torch.Tensor, h: int, w: int, maps: str,
               s: int = S) -> int:
    """Map pixels the crop must read: those under some sample's taps (the
    rows of a ROI's y taps by the columns of its x taps), over one map for
    a stride-0 map, else summed over the E maps."""
    ys, xs = coords(rois.cpu(), s)
    rows, cols = _touched(ys, h), _touched(xs, w)
    covered = (rows[..., :, None] & cols[..., None, :]).any(1)   # (E, H, W)
    if maps == "broadcast":
        covered = covered.any(0)
    return int(covered.sum())


def roi_reach(ys: torch.Tensor, xs: torch.Tensor, h: int) -> dict:
    """What a crop's ROIs cover, from their (E, R, S) sample coordinates
    in map cells: the mean and largest height and width in cells (last
    sample less first), and the mean and largest number of map rows with a
    y tap weight that is not zero (`_taps`), the rows a ROI's backward
    reaches."""
    ys, xs = ys.float().cpu(), xs.float().cpu()
    height = (ys[..., -1] - ys[..., 0]).abs()
    width = (xs[..., -1] - xs[..., 0]).abs()
    rows = _touched(ys, h).sum(-1).float()
    return {"height_mean": float(height.mean()),
            "height_max": float(height.max()),
            "width_mean": float(width.mean()), "width_max": float(width.max()),
            "rows_mean": float(rows.mean()), "rows_max": int(rows.max())}


def crop_bound(rois, h, w, c, elem, maps, s=S):
    """(bound ms, 'bytes' or 'operations', bytes, ops) of the forward on
    these ROIs: the map pixels under some tap read once (`tap_pixels`),
    the ROIs read, the crops written; `OPS_PER_OUTPUT` an output."""
    e, r = rois.shape[:2]
    out = e * r * s * s * c
    byts = tap_pixels(rois, h, w, maps, s) * c * elem + e * r * 16 + \
        out * elem
    return _bound(byts, out * OPS_PER_OUTPUT)


def crop_bwd_bound(rois, h, w, c, elem, s=S):
    """The same for the backward with respect to the map: the crops'
    gradient and the ROIs read, the maps' gradient written in full."""
    e, r = rois.shape[:2]
    out = e * r * s * s * c
    byts = out * elem + e * r * 16 + e * h * w * c * elem
    return _bound(byts, out * OPS_PER_OUTPUT)


def grid_sample_call(feat, rois, s=S):
    """The library yardstick: (fwd() -> one `F.grid_sample` call of the
    same crop (the maps as an NCHW view, bilinear, zero padding,
    align_corners=True: the reference's `_crop_pool_layer`), make_bwd() ->
    (bwd(gout) -> that call's gradient with respect to the maps, the
    graph kept; its output's shape))."""
    e, h, w, c = feat.shape
    r = rois.shape[1]
    ys, xs = coords(rois, s)
    gy = (ys * (2.0 / (h - 1)) - 1.0)[:, :, :, None].expand(e, r, s, s)
    gx = (xs * (2.0 / (w - 1)) - 1.0)[:, :, None, :].expand(e, r, s, s)
    grid = torch.stack([gx, gy], -1).reshape(e, r * s, s, 2).to(feat.dtype)
    nchw = feat.permute(0, 3, 1, 2)

    def fwd():
        with torch.no_grad():
            return F.grid_sample(nchw, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)

    def make_bwd():
        leaf = nchw.detach().requires_grad_(True)
        out = F.grid_sample(leaf, grid, mode="bilinear",
                            padding_mode="zeros", align_corners=True)
        return (lambda gout: torch.autograd.grad(out, leaf, gout,
                                                 retain_graph=True)[0],
                out.shape)
    return fwd, make_bwd


def plain_forward(feat, ys, xs, chunk=None, fn=crop_and_resize_plain):
    """A plain forward (the einsum pair, or `crop_gather_plain`), in
    chunks of `chunk` ROIs when given."""
    if chunk is None:
        return fn(feat, ys, xs)
    return torch.cat([fn(feat, ys[:, k:k + chunk], xs[:, k:k + chunk])
                      for k in range(0, ys.shape[1], chunk)], 1)


def ulps_at(got, want, mag):
    """Elementwise |got - want| in bf16 ulps of max(|want|, mag): `mag` the
    same sum over absolute values, the scale of the products that were
    summed (an error in one of them counts at their scale, not at that of
    a sum they cancel to)."""
    m = torch.maximum(want.float().abs(), mag.float().abs()).clamp(
        min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return (got.float() - want.float()).abs() / ulp


def _errors(got, want, mag, res, key):
    """The errors of `got` against `want` into res: bf16 ulps of `mag`'s
    scale (`ulps_at`) and raw, or for f32 the error over max|want|; the
    elements that differ."""
    res[key + "_diff_elements"] = res.get(key + "_diff_elements", 0) + \
        int((got != want).sum())
    if got.dtype == torch.bfloat16:
        new = {key + "_ulps": float(ulps_at(got, want, mag).max()),
               key + "_raw_ulps": int(bf16_ulp_distance(got, want).max())}
    else:
        new = {key + "_rel_err": float((got - want).abs().max()
                                       / want.abs().max().clamp(min=1e-30))}
    for k, v in new.items():
        res[k] = max(res.get(k, v), v)


def compare_shape(e, r, h, w, c, maps, dev, train=True, seed=0,
                  dtype=torch.bfloat16, s=S, chunk=None):
    """The kernels against the plain versions on one draw: (a dict of the
    errors, (feat, rois, grad, ys, xs)). The forward against
    `crop_gather_plain` (bit for bit) and the einsum pair (in ulps at the
    scale of the crop of |feat|); the backward twice, against
    `crop_bwd_coords_plain` (bit for bit) and autograd of the einsum pair
    (in ulps at the scale of the backward of |grad|)."""
    feat, rois, grad = crop_inputs(e, r, h, w, c, maps, dev, dtype, seed, s,
                                   with_grad=train)
    ys, xs = coords(rois, s)
    out = roi_crop_cuda.launch_forward(feat, ys, xs)
    mag = roi_crop_cuda.launch_forward(feat.abs(), ys, xs)
    res = {"shape": [e, r, h, w, c], "samples": s, "map": maps,
           "dtype": str(dtype).split(".")[-1],
           "finite": bool(torch.isfinite(out.float()).all()),
           "forward_gather_equal": True}
    step = chunk or r
    for k in range(0, r, step):
        sl = slice(k, k + step)
        part = out[:, sl]
        res["forward_gather_equal"] &= bool(torch.equal(
            part, crop_gather_plain(feat, ys[:, sl], xs[:, sl])))
        want = crop_and_resize_plain(feat, ys[:, sl], xs[:, sl])
        _errors(part, want, mag[:, sl], res, "forward")
        res["forward_max_abs_err"] = max(
            res.get("forward_max_abs_err", 0.0),
            float((part.float() - want.float()).abs().max()))
        del want
    del out, mag
    torch.cuda.synchronize()
    if train:
        d1 = roi_crop_cuda.launch_backward(grad, ys, xs, h, w)
        d2 = roi_crop_cuda.launch_backward(grad, ys, xs, h, w)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        res["bwd_repeat_equal"] = bool(torch.equal(d1.view(bits),
                                                   d2.view(bits)))
        del d2
        res["bwd_plain_equal"] = bool(torch.equal(
            d1, crop_bwd_coords_plain(grad, ys, xs, h, w)))
        leaf = feat.detach().requires_grad_(True)
        d_auto, = torch.autograd.grad(crop_and_resize_plain(leaf, ys, xs),
                                      leaf, grad)
        mag = roi_crop_cuda.launch_backward(grad.abs(), ys, xs, h, w)
        _errors(d1, d_auto, mag, res, "bwd_einsum")
        res["bwd_max_abs_err"] = float((d1.float() - d_auto.float())
                                       .abs().max())
        torch.cuda.synchronize()
        del d1, d_auto, leaf, mag
    return res, (feat, rois, grad, ys, xs)


def checks_pass(res) -> bool:
    """The forward finite and the same bits as `crop_gather_plain`, within
    `FWD_ULPS` (`FWD_F32_REL` for f32) of the einsum pair; the backward
    the same bits on two runs and as `crop_bwd_coords_plain`, within
    `BWD_ULPS` (`BWD_F32_REL`) of autograd of the einsum pair."""
    ok = res["finite"] and res["forward_gather_equal"] and \
        res.get("forward_ulps", 0.0) <= FWD_ULPS and \
        res.get("forward_rel_err", 0.0) <= FWD_F32_REL
    if "bwd_repeat_equal" in res:
        ok = ok and res["bwd_repeat_equal"] and res["bwd_plain_equal"] and \
            res.get("bwd_einsum_ulps", 0.0) <= BWD_ULPS and \
            res.get("bwd_einsum_rel_err", 0.0) <= BWD_F32_REL
    return ok


def check_shape(name, e, r, h, w, c, maps, train, dev, reps=20, seed=0,
                dtype=torch.bfloat16, s=S):
    """One shape: `compare_shape`, then the kernels timed beside their
    bounds, the plain versions (the einsum pair, in chunks at 'top'; the
    backward's fixed-order plain version and autograd of the einsum pair)
    and `library_ms` (`grid_sample_call`). Returns a dict of the
    numbers."""
    chunk = max(1, PLAIN_PAIRS // e) if e * r > PLAIN_PAIRS else None
    res, (feat, rois, grad, ys, xs) = compare_shape(
        e, r, h, w, c, maps, dev, train, seed, dtype, s, chunk)
    res["name"] = name
    elem = feat.element_size()
    res["ms"] = device_ms(lambda: roi_crop_cuda.launch_forward(feat, ys, xs),
                          reps)
    res["plain_ms"] = time_ms(lambda: plain_forward(feat, ys, xs, chunk), 1,
                              warmup=1)
    lib_fwd, make_lib_bwd = grid_sample_call(feat, rois, s)
    res["library_ms"] = time_ms(lib_fwd, reps, warmup=1)
    res["bound_ms"], res["bound_by"], res["bytes"], res["ops"] = \
        crop_bound(rois, h, w, c, elem, maps, s)
    # what the card's memory takes for the crops' bytes: a fill of a
    # tensor of their size, and a copy of one
    crops = torch.empty((e, r, s, s, c), dtype=dtype, device=dev)
    res["fill_ms"] = device_ms(lambda: crops.zero_(), reps)
    src = torch.zeros_like(crops)
    res["copy_ms"] = device_ms(lambda: crops.copy_(src), reps)
    del crops, src
    res["gb_per_s"] = res["bytes"] / res["ms"] / 1e6
    if train:
        res["bwd_ms"] = device_ms(lambda: roi_crop_cuda.launch_backward(
            grad, ys, xs, h, w), reps)
        res["bwd_plain_ms"] = time_ms(lambda: crop_bwd_coords_plain(
            grad, ys, xs, h, w), 1, warmup=0)
        leaf = feat.detach().requires_grad_(True)
        out = crop_and_resize_plain(leaf, ys, xs)
        res["bwd_einsum_ms"] = time_ms(lambda: torch.autograd.grad(
            out, leaf, grad, retain_graph=True), 3, warmup=1)
        del out, leaf
        lib_bwd, lib_shape = make_lib_bwd()
        gout = grad.permute(0, 4, 1, 2, 3).reshape(lib_shape)
        res["bwd_library_ms"] = time_ms(lambda: lib_bwd(gout), reps,
                                        warmup=1)
        res["bwd_bound_ms"], res["bwd_bound_by"], res["bwd_bytes"], _ = \
            crop_bwd_bound(rois, h, w, c, elem, s)
        res["bwd_gb_per_s"] = res["bwd_bytes"] / res["bwd_ms"] / 1e6
        res["band_plan"] = roi_crop_cuda.band_plan(h, w, c, dtype, s, e)
        del lib_bwd, gout
    return res


def baseline_band_plan(h, w, c, dtype, s=S):
    """(band_rows, chunk) that the earlier roi_crop.cu of `--baseline`
    reads from its C entry's two plan arguments: a CTA a 32-byte channel
    slab of a band of rows of (w + 1) pixels in f32 shared memory, a thread
    a row, channel pair and third of the columns (at most 1024), and the
    gradient of up to 32 ROIs staged beside it, within 227 KiB less its
    8.5 KiB of static shared memory."""
    elem = torch.empty((), dtype=dtype).element_size()
    smem, cs = 227 * 1024 - 8704 - 64, 32 // elem
    row_bytes, roi_bytes = (w + 1) * cs * 4, s * s * 32
    band_rows = min(h, (smem - roi_bytes) // row_bytes, 1024 // (cs // 2 * 3))
    return band_rows, min(32, (smem - band_rows * row_bytes) // roi_bytes)


def _baseline(path):
    """An earlier roi_crop.cu with this file's C interface, built with the
    port's flags beside its own libraries: (fwd(feat, ys, xs) -> out,
    bwd(grad, ys, xs, h, w) -> dfeat), the backward planned by
    `baseline_band_plan`."""
    src = Path(path).read_bytes()
    flags = _build._flags("roi_crop")
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = _build.BUILD_DIR / f"baseline-{key}" / "libroi_crop_base.so"
    if not lib_path.exists():
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([_build._nvcc(), *flags, "-o", str(lib_path),
                               str(path)], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"building {path} failed:\n{done.stdout}"
                               f"{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.roi_crop_fwd_launch.argtypes = [p, ll, i, i, i, i, i, p, p, i, i, p,
                                        p]
    lib.roi_crop_bwd_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i,
                                        p, p]

    def fwd(feat, ys, xs):
        e, h, w, c = feat.shape
        r, s = ys.shape[1], ys.shape[2]
        out = torch.empty((e, r, s, s, c), dtype=feat.dtype,
                          device=feat.device)
        rc = lib.roi_crop_fwd_launch(
            feat.data_ptr(), feat.stride(0), e, h, w, c,
            int(feat.dtype == torch.bfloat16), ys.data_ptr(), xs.data_ptr(),
            r, s, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline roi_crop forward: cudaError {rc}")
        return out

    def bwd(grad, ys, xs, h, w):
        e, r, s, _, c = grad.shape
        dfeat = torch.empty((e, h, w, c), dtype=grad.dtype,
                            device=grad.device)
        band_rows, chunk = baseline_band_plan(h, w, c, grad.dtype, s)
        rc = lib.roi_crop_bwd_launch(
            grad.data_ptr(), ys.data_ptr(), xs.data_ptr(), e, h, w, c,
            int(grad.dtype == torch.bfloat16), r, s, band_rows, chunk,
            dfeat.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline roi_crop backward: cudaError {rc}")
        return dfeat

    return fwd, bwd


def side_by_side(base, feat, ys, xs, grad=None, reps=20, rounds=3):
    """The baseline's kernels (`_baseline`'s pair) and this source's in
    turns on one input (baseline, this, this, baseline; `rounds` times):
    the mean device ms of each, forward and (with `grad`) backward, and
    whether the two give the same bits."""
    base_fwd, base_bwd = base
    h, w = feat.shape[1:3]
    fns = {"fwd": (lambda: base_fwd(feat, ys, xs),
                   lambda: roi_crop_cuda.launch_forward(feat, ys, xs))}
    if grad is not None:
        fns["bwd"] = (lambda: base_bwd(grad, ys, xs, h, w),
                      lambda: roi_crop_cuda.launch_backward(grad, ys, xs, h,
                                                            w))
    res = {}
    for key, (old, new) in fns.items():
        res[key + "_equal"] = bool(torch.equal(old(), new()))
        times = {"baseline": [], "this": []}
        for _ in range(rounds):
            for which in ("baseline", "this", "this", "baseline"):
                times[which].append(device_ms(
                    old if which == "baseline" else new, reps))
        res[key] = {k: float(np.mean(v)) for k, v in times.items()}
    return res


def baseline_ms(path, dev, reps=20, rounds=3):
    """`side_by_side` at `SHAPES`, `TOP_SHAPE` and `MAIN_PATH_EXTRA` (maps
    gathered where the backward runs, else one an expression), one dict a
    shape."""
    base = _baseline(path)
    shapes = [(name, e, r, h, w, c, maps, torch.bfloat16, train)
              for name, e, r, h, w, c, maps, train in SHAPES + (TOP_SHAPE,)]
    shapes += [(f"{e}x{r}_{h}x{w}x{c}_{str(dt).split('.')[-1]}", e, r, h, w,
                c, "gathered" if train else "distinct", dt, train)
               for e, r, h, w, c, dt, train in MAIN_PATH_EXTRA]
    out = []
    for name, e, r, h, w, c, maps, dtype, train in shapes:
        feat, rois, grad = crop_inputs(e, r, h, w, c, maps, dev, dtype,
                                       with_grad=train)
        ys, xs = coords(rois)
        res = {"name": name, **side_by_side(base, feat, ys, xs, grad, reps,
                                            rounds)}
        print(json.dumps(res), flush=True)
        out.append(res)
        del feat, rois, grad
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--baseline", default=None,
                    help="an earlier roi_crop.cu to time beside this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_crop needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.baseline:
        res = baseline_ms(args.baseline, dev, args.reps)
        print(json.dumps({"device": smi, "baseline": res}))
        return
    results = []
    for shape in SHAPES + (TOP_SHAPE,):
        res = check_shape(*shape, dev, reps=args.reps)
        print(json.dumps(res), flush=True)
        results.append(res)
        torch.cuda.empty_cache()
    ok = all(checks_pass(r) for r in results)
    print(json.dumps({"device": smi, "ok": ok, "shapes": results}))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
