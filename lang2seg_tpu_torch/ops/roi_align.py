"""ROI crop, batched over expressions.

Counterpart of `lang2seg_tpu/ops/roi_align.py::crop_and_resize` /
`roi_crop_pool`: the reference's `_crop_pool_layer` (affine_grid +
bilinear grid_sample with align_corners, nets/network.py:104-146)
samples the feature map at linspace(x1, x2, S) x linspace(y1, y2, S) in
feature-pixel coordinates with zero padding. Bilinear interpolation is
separable, so the plain version is two contractions with hat weights
w = max(0, 1 - |coord - index|), cast to the feature dtype as the JAX
package does. `crop_and_resize` runs it for a CPU tensor; a CUDA tensor
launches the hand kernels of `ops/roi_crop_cuda.py` (a 4-tap gather
forward and its fixed-order backward, `RoICrop`), which read the same
sample coordinates and round as the einsum pair does.

`roi_max_pool` is the counterpart of the JAX package's `roi_max_pool`
(POOLING_MODE 'pool', `lang2seg_tpu/ops/roi_align.py:123-216`): the
reference's RoIPool, rounded corners and [floor, ceil) bins, with its
gradient on each bin's first maximum in row-major order. A CPU tensor
takes the plain version below, which keeps the JAX formulation (masked
maxima over whole rows and columns) over chunks of ROIs; a CUDA tensor
launches the hand kernel of `ops/roi_pool_cuda.py`.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _sample_coords(rois: torch.Tensor, out_size: int, spatial_scale: float):
    """(..., R, S) y and x sample coordinates over the scaled ROI."""
    s = out_size
    x1 = rois[..., 0] * spatial_scale
    y1 = rois[..., 1] * spatial_scale
    x2 = rois[..., 2] * spatial_scale
    y2 = rois[..., 3] * spatial_scale
    t = torch.arange(s, dtype=torch.float32, device=rois.device) / (s - 1)
    ys = y1[..., None] + (y2 - y1)[..., None] * t
    xs = x1[..., None] + (x2 - x1)[..., None] * t
    return ys, xs


def _hat(coords: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """(..., n) hat weights max(0, 1 - |coord - index|) of (...) sample
    coordinates on an axis of n cells, in f32, cast to `dtype`."""
    idx = torch.arange(n, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(coords[..., None] - idx),
                       min=0.0).to(dtype)


def crop_and_resize_plain(feat: torch.Tensor, ys: torch.Tensor,
                          xs: torch.Tensor) -> torch.Tensor:
    """The einsum pair at given sample coordinates: feat (E, H, W, C), ys
    / xs (E, R, S) f32 in map cells -> (E, R, S, S, C) in feat's dtype."""
    h, w = feat.shape[1], feat.shape[2]
    wy = _hat(ys, h, feat.dtype)                           # (E, R, S, H)
    wx = _hat(xs, w, feat.dtype)                           # (E, R, S, W)
    # contract x first (W is usually the larger extent), then y per ROI
    tmp = torch.einsum("eyxc,erjx->eryjc", feat, wx)       # (E, R, H, S, C)
    return torch.einsum("eriy,eryjc->erijc", wy, tmp)      # (E, R, S, S, C)


def _taps(coords: torch.Tensor, n: int, dtype: torch.dtype):
    """The two taps floor(coord) + k, k = 0, 1, of (...) sample
    coordinates on an axis of n cells: [(index clamped to the axis,
    int64; hat weight in `dtype` as f32, 0 for a tap off the axis)] x 2."""
    first = torch.floor(coords)
    out = []
    for k in (0, 1):
        idx = first + k
        weight = torch.clamp(1.0 - torch.abs(coords - idx), min=0.0).to(dtype)
        inside = (idx >= 0) & (idx < n)
        out.append((idx.clamp(0, n - 1).long(),
                    torch.where(inside, weight.float(), 0.0)))
    return out


def crop_gather_plain(feat: torch.Tensor, ys: torch.Tensor,
                      xs: torch.Tensor) -> torch.Tensor:
    """The forward kernel's algorithm in torch ops, the 4-tap gather: for
    each sample, each of its two rows' two x taps weighted and summed in
    f32, rounded to feat's dtype, then the two rows weighted and summed in
    f32, rounded. A tap off the map adds 0. feat (E, H, W, C), ys / xs (E,
    R, S) -> (E, R, S, S, C) in feat's dtype."""
    e, h, w, c = feat.shape
    dt = feat.dtype
    f = feat.float()
    ar = torch.arange(e, device=feat.device)[:, None, None, None]
    xtaps = _taps(xs, w, dt)
    out = 0.0
    for yi, wy in _taps(ys, h, dt):
        row = 0.0
        for xi, wx in xtaps:
            row = row + wx[:, :, None, :, None] * \
                f[ar, yi[:, :, :, None], xi[:, :, None, :]]
        out = out + wy[:, :, :, None, None] * row.to(dt).float()
    return out.to(dt)


def crop_bwd_coords_plain(grad: torch.Tensor, ys: torch.Tensor,
                          xs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The crop's gradient with respect to the map at given sample
    coordinates, as the backward kernel computes it: for each ROI r in
    order and each sample column j in order, u = the sum over i = 0..S-1
    in order of wy * grad in f32, rounded to grad's dtype (the einsum's
    rounded intermediate), then wx * u added in f32 at the column's two
    taps; the sum rounded once. grad (E, R, S, S, C) -> (E, h, w, C)."""
    e, r, s, _, c = grad.shape
    dt, dev = grad.dtype, grad.device
    ytaps = _taps(ys, h, dt)                               # 2 x (E, R, S)
    xtaps = _taps(xs, w, dt)
    g = grad.float()
    ar = torch.arange(e, device=dev)
    acc = torch.zeros((e, h, w, c), dtype=torch.float32, device=dev)
    # only a sample's two taps have a weight that is not zero, and a tap
    # off the map adds 0 at a clamped index: each sum stays as it is
    for q in range(r):
        u = torch.zeros((e, h, s, c), dtype=torch.float32, device=dev)
        for i in range(s):
            for idx, weight in ytaps:
                y = idx[:, q, i]
                u[ar, y] = u[ar, y] + weight[:, q, i, None, None] * g[:, q, i]
        u = u.to(dt).float()
        for j in range(s):
            for idx, weight in xtaps:
                x = idx[:, q, j]
                acc[ar, :, x] = acc[ar, :, x] + \
                    weight[:, q, j, None, None] * u[:, :, j]
    return acc.to(dt)


def crop_and_resize_bwd_plain(feat: torch.Tensor, rois: torch.Tensor,
                              grad: torch.Tensor, out_size: int,
                              spatial_scale: float = 1.0) -> torch.Tensor:
    """The gradient of `crop_and_resize` with respect to feat (read for
    its shape alone), in the backward kernel's fixed order
    (`crop_bwd_coords_plain`). grad (E, R, S, S, C) -> (E, H, W, C) in
    grad's dtype."""
    ys, xs = _sample_coords(rois.float(), out_size, spatial_scale)
    return crop_bwd_coords_plain(grad, ys.contiguous(), xs.contiguous(),
                                 feat.shape[1], feat.shape[2])


class RoICrop(torch.autograd.Function):
    """The crop at given sample coordinates as an autograd node: the
    kernels on the card, the einsum pair and `crop_bwd_coords_plain` on
    the CPU. It saves the coordinates alone (the backward never reads the
    map); no gradient reaches them."""

    @staticmethod
    def forward(ctx, feat, ys, xs):
        ctx.save_for_backward(ys, xs)
        ctx.map_hw = (feat.shape[1], feat.shape[2])
        if feat.device.type == "cuda":
            from . import roi_crop_cuda
            return roi_crop_cuda.roi_crop_forward(feat, ys, xs)
        return crop_and_resize_plain(feat, ys, xs)

    @staticmethod
    def backward(ctx, grad):
        ys, xs = ctx.saved_tensors
        h, w = ctx.map_hw
        if grad.device.type == "cuda":
            from . import roi_crop_cuda
            return (roi_crop_cuda.roi_crop_backward(grad.contiguous(), ys, xs,
                                                    h, w), None, None)
        return crop_bwd_coords_plain(grad, ys, xs, h, w), None, None


def crop_and_resize(feat: torch.Tensor, rois: torch.Tensor, out_size: int,
                    spatial_scale: float = 1.0) -> torch.Tensor:
    """feat: (E, H, W, C); rois: (E, R, 4) [x1 y1 x2 y2] in image coords
    (times spatial_scale gives feature coords). Returns (E, R, S, S, C)
    in feat's dtype, differentiable in feat (never in the ROIs: proposals
    and GT boxes carry no gradient, and ROIs that require one raise). A
    CPU tensor takes the plain version, a CUDA tensor the kernels (each
    expression's (H, W, C) map contiguous, the expression stride free, 0
    for a broadcast map); another device raises."""
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"crop_and_resize: unsupported device {feat.device}")
    if torch.is_grad_enabled() and rois.requires_grad:
        raise ValueError("crop_and_resize: the ROIs carry no gradient; "
                         "detach them")
    ys, xs = _sample_coords(rois.float(), out_size, spatial_scale)
    ys, xs = ys.contiguous(), xs.contiguous()
    if torch.is_grad_enabled() and feat.requires_grad:
        return RoICrop.apply(feat, ys, xs)
    if feat.device.type == "cuda":
        from . import roi_crop_cuda
        return roi_crop_cuda.roi_crop_forward(feat, ys, xs)
    return crop_and_resize_plain(feat, ys, xs)


def roi_crop_pool(feat: torch.Tensor, rois: torch.Tensor, pooling_size: int,
                  spatial_scale: float, max_pool: bool = False
                  ) -> torch.Tensor:
    """The reference's `_crop_pool_layer`: a direct SxS crop, or a 2Sx2S
    crop then 2x2 max pool when max_pool (cfg.RESNET.MAX_POOL)."""
    if not max_pool:
        return crop_and_resize(feat, rois, pooling_size, spatial_scale)
    crops = crop_and_resize(feat, rois, pooling_size * 2, spatial_scale)
    e, r, s2, _, c = crops.shape
    crops = crops.reshape(e, r, s2 // 2, 2, s2 // 2, 2, c)
    return crops.amax(dim=(3, 5))


# ---------------------------------------------------------------------------
# ROI max pooling (POOLING_MODE 'pool')
# ---------------------------------------------------------------------------

# the plain version's largest intermediate: the JAX formulation's masked
# (chunk, P, H, W, C) forward and (chunk, P, P, H, W, C) backward tensors,
# which XLA fuses away and eager PyTorch builds, are cut to about this size
CHUNK_BYTES = 1 << 30


def roi_pool_bins(rois: torch.Tensor, pooled: int, spatial_scale: float,
                  h: int, w: int) -> Tuple[torch.Tensor, ...]:
    """Each bin's [start, end) rows and columns, the reference's RoIPool
    windows (roi_pool_py.py:20-38): corners rounded half to even after
    scaling, an extent of at least 1, bin k over [floor(k * b),
    ceil((k + 1) * b)) from the corner, in f32, clipped to the map.
    rois (..., R, 4) f32 -> hs, he, ws, we, each (..., R, P) int64."""
    r = torch.round(rois.float() * spatial_scale).to(torch.int32)
    x1, y1, x2, y2 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    rw = torch.clamp(x2 - x1 + 1, min=1).float()
    rh = torch.clamp(y2 - y1 + 1, min=1).float()
    # a true f32 quotient: on CUDA, torch divides by a Python number as a
    # product with its f32 reciprocal (21 * (1/7) = 3.0000002, whose ceil
    # is 4), so the divisor is a tensor on the ROIs' device
    p = torch.full_like(rw, float(pooled))
    bw = rw / p
    bh = rh / p
    k = torch.arange(pooled, dtype=torch.float32, device=rois.device)
    hs = torch.floor(k * bh[..., None]).to(torch.int32) + y1[..., None]
    he = torch.ceil((k + 1) * bh[..., None]).to(torch.int32) + y1[..., None]
    ws = torch.floor(k * bw[..., None]).to(torch.int32) + x1[..., None]
    we = torch.ceil((k + 1) * bw[..., None]).to(torch.int32) + x1[..., None]
    return (torch.clamp(hs, 0, h).long(), torch.clamp(he, 0, h).long(),
            torch.clamp(ws, 0, w).long(), torch.clamp(we, 0, w).long())


def _memberships(bins, h: int, w: int, device):
    hs, he, ws, we = bins
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    my = (ys >= hs[..., None]) & (ys < he[..., None])        # (..., R, P, H)
    mx = (xs >= ws[..., None]) & (xs < we[..., None])        # (..., R, P, W)
    empty = (he <= hs)[..., :, None] | (we <= ws)[..., None, :]
    return my, mx, empty                                     # empty (.., P, P)


def _chunk(per_roi_bytes: int, chunk_bytes: int) -> int:
    return max(1, chunk_bytes // max(per_roi_bytes, 1))


def roi_max_pool_plain(feat: torch.Tensor, rois: torch.Tensor, pooled: int,
                       spatial_scale: float,
                       chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """feat (E, H, W, C); rois (E, R, 4) [x1 y1 x2 y2] in image coords.
    Returns (E, R, P, P, C) in feat's dtype: each bin's maximum, 0 for an
    empty bin. The JAX formulation (the rows of each h-bin first, then the
    columns of each w-bin), over chunks of ROIs."""
    e, h, w, c = feat.shape
    r = rois.shape[1]
    my, mx, empty = _memberships(roi_pool_bins(rois, pooled, spatial_scale,
                                               h, w), h, w, feat.device)
    neg = torch.tensor(float("-inf"), dtype=feat.dtype, device=feat.device)
    out = torch.empty((e, r, pooled, pooled, c), dtype=feat.dtype,
                      device=feat.device)
    step = _chunk(pooled * h * w * c * feat.element_size(), chunk_bytes)
    for i in range(e):
        f = feat[i]
        for s in range(0, r, step):
            sl = slice(s, s + step)
            rowmax = torch.where(my[i, sl, :, :, None, None], f, neg).amax(2)
            out[i, sl] = torch.where(mx[i, sl, None, :, :, None],
                                     rowmax[:, :, None], neg).amax(3)
    return torch.where(empty[..., None], torch.zeros((), dtype=feat.dtype,
                                                     device=feat.device), out)


def roi_max_pool_argmax_plain(feat: torch.Tensor, rois: torch.Tensor,
                              pooled: int, spatial_scale: float,
                              chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """Each output's position y * W + x in its bin: the first maximum in
    row-major order, as the JAX package's `_roi_max_pool_bwd` takes it
    (argmax over the flattened masked window); -1 for an empty bin.
    (E, R, P, P, C) int64."""
    e, h, w, c = feat.shape
    r = rois.shape[1]
    my, mx, empty = _memberships(roi_pool_bins(rois, pooled, spatial_scale,
                                               h, w), h, w, feat.device)
    neg = torch.tensor(float("-inf"), dtype=feat.dtype, device=feat.device)
    amax = torch.empty((e, r, pooled, pooled, c), dtype=torch.int64,
                       device=feat.device)
    step = _chunk(pooled * pooled * h * w * c * feat.element_size(),
                  chunk_bytes)
    for i in range(e):
        f = feat[i]
        for s in range(0, r, step):
            sl = slice(s, s + step)
            member = my[i, sl, :, None, :, None] & mx[i, sl, None, :, None, :]
            vals = torch.where(member[..., None], f, neg)   # (r, P, P, H, W, C)
            amax[i, sl] = vals.reshape(*vals.shape[:3], h * w, c).argmax(3)
    return torch.where(empty[..., None], -1, amax)


def roi_max_pool_bwd_plain(feat: torch.Tensor, rois: torch.Tensor,
                           grad: torch.Tensor, pooled: int,
                           spatial_scale: float,
                           chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """The gradient of `roi_max_pool_plain` with respect to feat, as the
    JAX package's `_roi_max_pool_bwd` computes it: each output's gradient
    added, in f32, at its bin's first maximum in row-major order
    (`roi_max_pool_argmax_plain`), nothing for an empty bin; the sum cast
    once to feat's dtype. grad (E, R, P, P, C) -> (E, H, W, C)."""
    e, h, w, c = feat.shape
    amax = roi_max_pool_argmax_plain(feat, rois, pooled, spatial_scale,
                                     chunk_bytes)
    gz = torch.where(amax < 0, 0.0, grad.float())
    flat = torch.clamp(amax, min=0) * c + torch.arange(c, device=feat.device)
    dfeat = torch.zeros((e, h * w * c), dtype=torch.float32,
                        device=feat.device)
    # the updates in the JAX scatter's order: (R, P, P, C) row-major
    for i in range(e):
        dfeat[i].index_put_((flat[i].reshape(-1),), gz[i].reshape(-1),
                            accumulate=True)
    return dfeat.reshape(e, h, w, c).to(feat.dtype)


class RoIMaxPool(torch.autograd.Function):
    """`roi_max_pool` as an autograd node. On the card the forward kernel
    saves each output's argmax as a bin-local code and the backward kernel
    adds to it (the map saved beside it, read only for a bin too large for
    its code); on the CPU the backward recomputes the argmax from (feat,
    rois), as the JAX package's custom VJP does. No gradient reaches the
    ROIs."""

    @staticmethod
    def forward(ctx, feat, rois, pooled, spatial_scale):
        ctx.args = (pooled, spatial_scale)
        if feat.device.type == "cuda":
            from . import roi_pool_cuda
            out, codes = roi_pool_cuda.roi_pool_forward(
                feat, rois, pooled, spatial_scale)
            ctx.save_for_backward(feat, rois, codes)
            return out
        ctx.save_for_backward(feat, rois)
        return roi_max_pool_plain(feat, rois, pooled, spatial_scale)

    @staticmethod
    def backward(ctx, grad):
        pooled, spatial_scale = ctx.args
        if grad.device.type == "cuda":
            from . import roi_pool_cuda
            feat, rois, codes = ctx.saved_tensors
            return (roi_pool_cuda.roi_pool_backward(
                grad.contiguous(), codes, feat, rois, pooled, spatial_scale),
                None, None, None)
        feat, rois = ctx.saved_tensors
        return (roi_max_pool_bwd_plain(feat, rois, grad, pooled,
                                       spatial_scale), None, None, None)


def roi_max_pool(feat: torch.Tensor, rois: torch.Tensor, pooled: int,
                 spatial_scale: float) -> torch.Tensor:
    """ROI max pooling, batched over expressions: feat (E, H, W, C), rois
    (E, R, 4) [x1 y1 x2 y2] in image coords (times spatial_scale gives
    feature coords) -> (E, R, P, P, C) in feat's dtype; differentiable in
    feat. A CPU tensor takes the plain version, a CUDA tensor the kernel
    (each expression's (H, W, C) map contiguous, the expression stride
    free, 0 for a broadcast map); another device raises. Where no gradient
    is wanted (serving, or a map that does not require one) the kernel
    writes no argmax."""
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"roi_max_pool: unsupported device {feat.device}")
    if torch.is_grad_enabled() and feat.requires_grad:
        return RoIMaxPool.apply(feat, rois, pooled, spatial_scale)
    if feat.device.type == "cuda":
        from . import roi_pool_cuda
        return roi_pool_cuda.roi_pool_forward(
            feat, rois, pooled, spatial_scale, with_argmax=False)[0]
    return roi_max_pool_plain(feat, rois, pooled, spatial_scale)
