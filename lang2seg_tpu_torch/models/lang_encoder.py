"""Referring-expression encoder: Embedding -> word dropout -> Linear+ReLU
-> bi-LSTM over variable lengths.

Counterpart of `lang2seg_tpu/models/lang_encoder.py::RNNEncoder` and of
the reference's `lib/layers/lang_encoder.py:11-82`. Parameters carry the
reference's names (`embedding`, `mlp.0`, `rnn.weight_ih_l0[_reverse]`,
...) and torch's gate order (i, f, g, o). The recurrence is the JAX
package's masked scan: padding token 0, lengths = (labels != 0).sum(1),
the carry updates only while t < length, and the backward direction
runs over each row's valid prefix reversed — both directions in one
loop of T steps. Word dropout (`input_dropout_p`) acts in train mode only
and draws its mask from the caller's `torch.Generator`, as flax's
`nn.Dropout` does from its rng: keep where uniform < 1 - p, scale the kept
values by 1 / (1 - p).

Returns (output (B, T, 2H), hidden (B, 2H), embedded (B, T, D)).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


def word_dropout(x: torch.Tensor, p: float,
                 generator: torch.Generator) -> torch.Tensor:
    """flax `nn.Dropout(p)` in train mode: each element is kept where a
    uniform draw is below 1 - p and then divided by 1 - p, else zeroed.
    The draws come from `generator`, on its own device (a CPU generator
    gives the same mask on every device), and move to x's device."""
    keep_p = 1.0 - p
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    keep = u.to(x.device) < keep_p
    return torch.where(keep, x / keep_p, torch.zeros_like(x))


class RNNEncoder(nn.Module):
    def __init__(self, vocab_size: int, word_embedding_size: int = 512,
                 word_vec_size: int = 512, hidden_size: int = 512,
                 bidirectional: bool = True, input_dropout_p: float = 0.5):
        super().__init__()
        self.hidden_size = hidden_size
        self.bidirectional = bidirectional
        self.input_dropout_p = input_dropout_p
        self.embedding = nn.Embedding(vocab_size, word_embedding_size)
        self.mlp = nn.Sequential(nn.Linear(word_embedding_size, word_vec_size),
                                 nn.ReLU())
        # parameter holder only: the recurrence below reads its weights
        self.rnn = nn.LSTM(word_vec_size, hidden_size, 1, batch_first=True,
                           bidirectional=bidirectional)

    def _direction_params(self):
        sfx = ["_l0"] + (["_l0_reverse"] if self.bidirectional else [])
        r = self.rnn
        return (torch.stack([getattr(r, "weight_ih" + s) for s in sfx]),
                torch.stack([getattr(r, "weight_hh" + s) for s in sfx]),
                torch.stack([getattr(r, "bias_ih" + s) for s in sfx]),
                torch.stack([getattr(r, "bias_hh" + s) for s in sfx]))

    def forward(self, labels: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """labels: (B, T) int, 0 = PAD. In train mode with a dropout rate
        above 0, `generator` draws the word-dropout mask (required)."""
        b, t = labels.shape
        lengths = (labels != 0).sum(1)
        embedded = self.embedding(labels.long())
        if self.training and self.input_dropout_p > 0.0:
            if generator is None:
                raise ValueError("RNNEncoder: word dropout in train mode "
                                 "needs a torch.Generator")
            embedded = word_dropout(embedded, self.input_dropout_p, generator)
        embedded = self.mlp(embedded)
        d = embedded.shape[-1]

        pos = torch.arange(t, device=labels.device)[None, :]
        valid = pos < lengths[:, None]                          # (B, T)
        rev_idx = torch.clamp(lengths[:, None] - 1 - pos, 0, t - 1)
        xs = [embedded]
        if self.bidirectional:
            xs.append(torch.gather(embedded, 1,
                                   rev_idx[..., None].expand(b, t, d)))
        x2 = torch.stack(xs)                                    # (N, B, T, D)
        w_ih, w_hh, b_ih, b_hh = self._direction_params()
        n, hsz = x2.shape[0], self.hidden_size
        gx = torch.einsum("nbtd,ngd->nbtg", x2, w_ih)           # (N, B, T, 4H)

        h = embedded.new_zeros((n, b, hsz))
        c = embedded.new_zeros((n, b, hsz))
        outs = []
        for step in range(t):
            gates = (gx[:, :, step] + torch.bmm(h, w_hh.transpose(1, 2))
                     + b_ih[:, None, :] + b_hh[:, None, :])
            i, f, g, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            v = valid[None, :, step, None]
            h = torch.where(v, h_new, h)
            c = torch.where(v, c_new, c)
            outs.append(torch.where(v, h_new, torch.zeros_like(h_new)))
        out = torch.stack(outs, dim=2)                          # (N, B, T, H)

        output = out[0]
        hidden = h[0]
        if self.bidirectional:
            # scatter back: out_b[i] = out_r[len-1-i] for i < len, else 0
            out_b = torch.gather(out[1], 1,
                                 rev_idx[..., None].expand(b, t, hsz))
            out_b = torch.where(valid[..., None], out_b,
                                torch.zeros_like(out_b))
            output = torch.cat([output, out_b], dim=-1)
            hidden = torch.cat([h[0], h[1]], dim=-1)
        return output, hidden, embedded
