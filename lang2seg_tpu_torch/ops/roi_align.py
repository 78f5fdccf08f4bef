"""ROI crop, batched over expressions.

Counterpart of `lang2seg_tpu/ops/roi_align.py::crop_and_resize` /
`roi_crop_pool`: the reference's `_crop_pool_layer` (affine_grid +
bilinear grid_sample with align_corners, nets/network.py:104-146)
samples the feature map at linspace(x1, x2, S) x linspace(y1, y2, S) in
feature-pixel coordinates with zero padding. Bilinear interpolation is
separable, so the crop is two contractions with hat weights
w = max(0, 1 - |coord - index|), cast to the feature dtype as the JAX
package does.
"""

from __future__ import annotations

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


def crop_and_resize(feat: torch.Tensor, rois: torch.Tensor, out_size: int,
                    spatial_scale: float = 1.0) -> torch.Tensor:
    """feat: (E, H, W, C); rois: (E, R, 4) [x1 y1 x2 y2] in image coords
    (times spatial_scale gives feature coords). Returns (E, R, S, S, C)
    in feat's dtype."""
    h, w = feat.shape[1], feat.shape[2]
    ys, xs = _sample_coords(rois.float(), out_size, spatial_scale)
    iy = torch.arange(h, dtype=torch.float32, device=feat.device)
    ix = torch.arange(w, dtype=torch.float32, device=feat.device)
    wy = torch.clamp(1.0 - torch.abs(ys[..., None] - iy), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(xs[..., None] - ix), min=0.0)
    wy = wy.to(feat.dtype)                                 # (E, R, S, H)
    wx = wx.to(feat.dtype)                                 # (E, R, S, W)
    # contract x first (W is usually the larger extent), then y per ROI
    tmp = torch.einsum("eyxc,erjx->eryjc", feat, wx)       # (E, R, H, S, C)
    return torch.einsum("eriy,eryjc->erijc", wy, tmp)      # (E, R, S, S, C)


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
