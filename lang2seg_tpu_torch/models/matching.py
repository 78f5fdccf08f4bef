"""MAttNet matching modules that the reference tree carries.

Counterpart of `lang2seg_tpu/models/matching.py`. The reference vendors
these modules from MAttNet without using them on its training paths
(PhraseAttention `lib/layers/lang_encoder.py:85-114`,
MaxMarginCriterion `lib/crits/max_margin_crit.py:9-51`, VisualEncoder
`lib/layers/visual_encoder.py:36`, JointMatching
`lib/layers/joint_match.py:115`): phrase-attended matching of regions to
expressions with a paired / unpaired ranking loss. Nothing on the main
path calls them, in the JAX package or here. The JAX package's
`nn.Dense` layers are `nn.Linear` under its names (`fc`, `proj1`,
`proj2`, `vis_emb`, `lang_emb`); flax infers their input widths, which
are arguments here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class PhraseAttention(nn.Module):
    """Word-attention pooling over encoder states (lang_encoder.py:85-114):
    scores = fc(context); the softmax masked to non-pad tokens and
    renormalized; the weighted sum of the embeddings."""

    def __init__(self, context_dim: int):
        super().__init__()
        self.fc = nn.Linear(context_dim, 1)

    def forward(self, context: torch.Tensor, embedded: torch.Tensor,
                labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """context (B, T, D); embedded (B, T, E); labels (B, T) int.
        Returns (attn (B, T), weighted_emb (B, E))."""
        attn = torch.softmax(self.fc(context)[..., 0], dim=-1)
        attn = attn * (labels != 0).to(attn.dtype)
        attn = attn / torch.clamp(attn.sum(dim=1, keepdim=True), min=1e-8)
        return attn, torch.bmm(attn[:, None, :], embedded)[:, 0]


def max_margin_loss(paired_scores: torch.Tensor,
                    unpaired_vis: torch.Tensor,
                    unpaired_lang: torch.Tensor, margin: float = 0.1,
                    vis_weight: float = 1.0,
                    lang_weight: float = 1.0) -> torch.Tensor:
    """The paired / unpaired ranking loss (max_margin_crit.py:9-51):
    mean(relu(margin + unpaired - paired)) over both negative kinds."""
    vis = torch.clamp(margin + unpaired_vis - paired_scores, min=0.0)
    lang = torch.clamp(margin + unpaired_lang - paired_scores, min=0.0)
    return vis_weight * vis.mean() + lang_weight * lang.mean()


class VisualEncoder(nn.Module):
    """Region encoder for matching (visual_encoder.py:36): pooled region
    features and location features into the joint embedding space."""

    def __init__(self, region_dim: int, loc_dim: int, dim: int = 512):
        super().__init__()
        self.proj1 = nn.Linear(region_dim + loc_dim, dim)
        self.proj2 = nn.Linear(dim, dim)

    def forward(self, region_feats: torch.Tensor,
                loc_feats: torch.Tensor) -> torch.Tensor:
        x = torch.cat([region_feats, loc_feats], dim=-1)
        return self.proj2(F.relu(self.proj1(x)))


class JointMatching(nn.Module):
    """Cosine matching score between encoded regions and phrase-attended
    language (joint_match.py:115)."""

    def __init__(self, visual_dim: int, lang_dim: int, dim: int = 512):
        super().__init__()
        self.vis_emb = nn.Linear(visual_dim, dim)
        self.lang_emb = nn.Linear(lang_dim, dim)

    def forward(self, visual_emb: torch.Tensor,
                lang_emb: torch.Tensor) -> torch.Tensor:
        v = self.vis_emb(visual_emb)
        lv = self.lang_emb(lang_emb)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-8)
        lv = lv / torch.clamp(
            torch.linalg.vector_norm(lv, dim=-1, keepdim=True), min=1e-8)
        return torch.sum(v * lv, dim=-1)
