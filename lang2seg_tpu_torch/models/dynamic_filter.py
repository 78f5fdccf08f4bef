"""Language-conditioned dynamic-filter response.

Counterpart of `lang2seg_tpu/models/dynamic_filter.py::DynamicFilterGen`
(reference `nets/network.py:474-479` baseline, `network_7f.py:475-533`
spatial, `network_7f_response.py:543-545` sigmoid gate). The filters are
tanh(Linear(hidden)) per head (`filters`), under the reference's names
(`dynamic_fc` for one filter, `dynamic_fc_0..6` and `response_fc` for
seven); the contraction, masks, response fuse and gate (`gate_map`) run
in one call of `ops/fused_filter.py` (the CUDA kernel on a card), an
autograd node whose backward (the second kernel on a card) gives the map,
the filters and through them `dynamic_fc_k` / `response_fc` their
gradients.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.fused_filter import fused_dynamic_filter


def spatial_masks_7(h: int, w: int, dtype=torch.float32,
                    device="cpu") -> torch.Tensor:
    """(7, H, W) indicator masks matching network_7f.py:501-539: full, top
    half, bottom half, left half, right half, middle horizontal band,
    middle vertical band (int-floor boundaries)."""
    ys = torch.arange(h, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, device=device)[None, :].expand(h, w)
    masks = torch.stack([
        torch.ones((h, w), dtype=torch.bool, device=device),
        ys < h // 2,
        ys >= h // 2,
        xs < w // 2,
        xs >= w // 2,
        (ys >= h // 4) & (ys < (h * 3) // 4),
        (xs >= w // 4) & (xs < (w * 3) // 4)])
    return masks.to(dtype)


class DynamicFilterGen(nn.Module):
    def __init__(self, hidden_dim: int, c4_dim: int = 1024,
                 num_filters: int = 1, gate: str = "multiply",
                 normalize: bool = False):
        super().__init__()
        if num_filters not in (1, 7):
            raise ValueError(f"num_filters must be 1 or 7, got {num_filters}")
        self.c4_dim = c4_dim
        self.num_filters = num_filters
        self.gate = gate
        self.normalize = normalize
        if num_filters == 1:
            self.dynamic_fc = nn.Linear(hidden_dim, c4_dim)
        else:
            for k in range(num_filters):
                self.add_module(f"dynamic_fc_{k}",
                                nn.Linear(hidden_dim, c4_dim))
            self.response_fc = nn.Linear(hidden_dim, num_filters)

    def filters(self, hidden: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """hidden (E, D) -> the filters (E, C, K) and the response filters
        (E, K), f32 and contiguous: tanh(Linear(hidden)) a head (ones for
        one filter's response)."""
        e = hidden.shape[0]
        if self.num_filters == 1:
            filt = torch.tanh(self.dynamic_fc(hidden))[..., None]
            rfilt = hidden.new_ones((e, 1))
        else:
            filt = torch.stack(
                [torch.tanh(getattr(self, f"dynamic_fc_{k}")(hidden))
                 for k in range(self.num_filters)], dim=-1)      # (E, C, K)
            rfilt = torch.tanh(self.response_fc(hidden))         # (E, K)
        return filt.float().contiguous(), rfilt.float().contiguous()

    def gate_map(self, net_conv: torch.Tensor, filt: torch.Tensor,
                 rfilt: torch.Tensor, exprs_per_map: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The contraction, masks, response fuse and gate of `filters`'
        output on net_conv (`forward`)."""
        return fused_dynamic_filter(
            net_conv, filt, rfilt, num_filters=self.num_filters,
            gate=self.gate, normalize=self.normalize,
            exprs_per_map=exprs_per_map)

    def forward(self, net_conv: torch.Tensor, hidden: torch.Tensor,
                exprs_per_map: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """net_conv: (E // G, H, W, C) maps, G = exprs_per_map consecutive
        expressions reading each (a stride-0 broadcast of one image's map
        at G = 1); hidden: (E, D). Returns (gated (E, H, W, C), response
        (E, H, W, 1) f32)."""
        return self.gate_map(net_conv, *self.filters(hidden), exprs_per_map)
