"""Att2in2 captioner, the decoder of the caption-consistency loss.

Counterpart of `lang2seg_tpu/models/captioner.py::Att2In2Captioner` and of
the reference's decoder (`lib/caption_models/AttModel.py`: the att2in2
core :426-466, additive attention :397-423, `LanguageModelCriterion` in
`lib/misc/utils.py:39-53`): word embed -> ReLU -> dropout; fc and att
feature embeds; the attention keys projected once (`ctx2att`); per step
an LSTM core whose cell input takes the attended feature through `a2c`
and a maxout; log-softmax over vocab + 1 words (0 is BOS / EOS / PAD, the
last index UNK).

Parameters carry the reference's keys (`embed.0`, `fc_embed.0`,
`att_embed.0`, `ctx2att`, `core.{i2h,h2h,a2c}`,
`core.attention.{h2att,alpha_net}`, `logit`), which the JAX package's
`engine/convert.py::convert_captioner` reads.

Random draws (dropout at `drop_prob_lm` in train mode, scheduled
sampling) come from the caller's `torch.Generator`, on its own device, as
`lang_encoder.word_dropout` draws: in the feature embeds' order fc, att,
then per step the scheduled-sampling draws (a uniform per row, then the
Gumbel noise of the categorical sample), the word embed's mask and the
core output's mask. Nothing reads a value back to the host. Ties in
`argmax` and in the beam's top-k go to the lowest index, as `jnp.argmax`
and `lax.top_k` give them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .lang_encoder import word_dropout


class _Attention(nn.Module):
    def __init__(self, rnn_size: int, att_hid_size: int):
        super().__init__()
        self.h2att = nn.Linear(rnn_size, att_hid_size)
        self.alpha_net = nn.Linear(att_hid_size, 1)

    def forward(self, h, att, p_att):
        """softmax(alpha(tanh(p_att + h2att(h)))) @ att."""
        q = self.h2att(h)[:, None, :]                         # (B, 1, Ah)
        e = self.alpha_net(torch.tanh(p_att + q))[..., 0]     # (B, L)
        w = torch.softmax(e, dim=-1)
        return torch.bmm(w[:, None, :], att)[:, 0]            # (B, R)


class _Att2In2Core(nn.Module):
    def __init__(self, input_encoding_size: int, rnn_size: int,
                 att_hid_size: int):
        super().__init__()
        self.rnn_size = rnn_size
        self.i2h = nn.Linear(input_encoding_size, 5 * rnn_size)
        self.h2h = nn.Linear(rnn_size, 5 * rnn_size)
        self.a2c = nn.Linear(rnn_size, 2 * rnn_size)
        self.attention = _Attention(rnn_size, att_hid_size)

    def forward(self, xt, att, p_att, h, c):
        r = self.rnn_size
        att_res = self.attention(h, att, p_att)
        s = self.i2h(xt) + self.h2h(h)
        gates = torch.sigmoid(s[:, :3 * r])
        i_g, f_g, o_g = gates[:, :r], gates[:, r:2 * r], gates[:, 2 * r:]
        it = s[:, 3 * r:] + self.a2c(att_res)
        it = torch.maximum(it[:, :r], it[:, r:])              # maxout
        c_new = f_g * c + i_g * it
        return o_g * torch.tanh(c_new), c_new


def _gumbel_argmax(logp: torch.Tensor, generator: torch.Generator
                   ) -> torch.Tensor:
    """A categorical draw per row of log-probs, as argmax(logp + Gumbel
    noise): jax.random.categorical's method, without a host round trip."""
    u = torch.rand(logp.shape, generator=generator, device=generator.device)
    u = u.to(logp.device).clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logp - torch.log(-torch.log(u)), dim=-1)


class Att2In2Captioner(nn.Module):
    """`vocab_size` counts the words without the +1 of index 0."""

    def __init__(self, vocab_size: int, seq_length: int = 10,
                 rnn_size: int = 512, input_encoding_size: int = 512,
                 att_hid_size: int = 512, fc_feat_size: int = 4096,
                 att_feat_size: int = 4096, drop_prob_lm: float = 0.5,
                 ss_prob: float = 0.0):
        super().__init__()
        self.vocab_size = vocab_size
        self.seq_length = seq_length
        self.rnn_size = rnn_size
        self.drop_prob_lm = drop_prob_lm
        self.ss_prob = ss_prob
        v1 = vocab_size + 1
        self.embed = nn.Sequential(nn.Embedding(v1, input_encoding_size))
        self.fc_embed = nn.Sequential(nn.Linear(fc_feat_size, rnn_size))
        self.att_embed = nn.Sequential(nn.Linear(att_feat_size, rnn_size))
        self.ctx2att = nn.Linear(rnn_size, att_hid_size)
        self.core = _Att2In2Core(input_encoding_size, rnn_size, att_hid_size)
        self.logit = nn.Linear(rnn_size, v1)

    # ---------- step pieces ----------

    def _dropout(self, x, generator):
        if generator is None or self.drop_prob_lm <= 0.0:
            return x
        return word_dropout(x, self.drop_prob_lm, generator)

    def _prep_feats(self, fc_feats, att_feats, generator=None):
        fc = self._dropout(F.relu(self.fc_embed(fc_feats)), generator)
        att = self._dropout(F.relu(self.att_embed(att_feats)), generator)
        return fc, att, self.ctx2att(att)

    def _embed_word(self, it, generator=None):
        return self._dropout(F.relu(self.embed(it)), generator)

    def _step_logp(self, it, att, p_att, h, c):
        """One eval-mode step: (log-probs (B, V+1), h, c)."""
        h, c = self.core(self._embed_word(it), att, p_att, h, c)
        return torch.log_softmax(self.logit(h), dim=-1), h, c

    def _train_generator(self, generator):
        if not self.training:
            return None
        if generator is None and self.drop_prob_lm > 0.0:
            raise ValueError("Att2In2Captioner: dropout in train mode needs "
                             "a torch.Generator")
        return generator

    # ---------- teacher forcing ----------

    def teacher_forced_logprobs(self, fc_feats, att_feats, seq,
                                generator: Optional[torch.Generator] = None,
                                ss_prob: Optional[float] = None
                                ) -> torch.Tensor:
        """seq: (B, T) with BOS = 0 at column 0. Returns the log-probs
        (B, T-1, V+1) of predicting seq[:, 1:]. In train mode dropout and
        scheduled sampling (`ss_prob`, default self.ss_prob: with that
        probability per row, steps >= 1 feed a sample of the previous
        step's distribution instead of the ground-truth word) draw from
        `generator`."""
        gen = self._train_generator(generator)
        p_ss = self.ss_prob if ss_prob is None else float(ss_prob)
        use_ss = self.training and p_ss > 0.0
        if use_ss and generator is None:
            raise ValueError("Att2In2Captioner: scheduled sampling needs a "
                             "torch.Generator")
        b, t = seq.shape
        fc, att, p_att = self._prep_feats(fc_feats, att_feats, gen)
        h = fc.new_zeros((b, self.rnn_size))
        c = h
        outs, logps = [], []
        for i in range(t - 1):
            it = seq[:, i].long()
            if use_ss and i >= 1:
                u = torch.rand((b,), generator=generator,
                               device=generator.device).to(seq.device)
                sampled = _gumbel_argmax(logps[-1].detach(), generator)
                it = torch.where(u < p_ss, sampled, it)
            xt = self._embed_word(it, gen)
            h, c = self.core(xt, att, p_att, h, c)
            out = self._dropout(h, gen)
            if use_ss:
                logps.append(torch.log_softmax(self.logit(out), dim=-1))
            else:
                outs.append(out)
        if use_ss:
            return torch.stack(logps, dim=1)
        return torch.log_softmax(self.logit(torch.stack(outs, dim=1)), dim=-1)

    def teacher_forced_nll(self, fc_feats, att_feats, seq, mask,
                           generator: Optional[torch.Generator] = None,
                           ss_prob: Optional[float] = None) -> torch.Tensor:
        """LanguageModelCriterion: the masked mean NLL of seq[:, 1:] under
        the teacher-forced distribution."""
        logps = self.teacher_forced_logprobs(fc_feats, att_feats, seq,
                                             generator, ss_prob)
        target = seq[:, 1:].long()
        m = mask[:, 1:1 + logps.shape[1]].to(logps.dtype)
        nll = -torch.gather(logps, -1, target[..., None])[..., 0]
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)

    # ---------- sampling ----------

    @torch.no_grad()
    def sample_greedy(self, fc_feats, att_feats
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy decode (reference sample with sample_max=1,
        AttModel.py:160-209). Returns (seq (B, T) int64, the chosen words'
        log-probs (B, T)); a row is 0 from its first EOS on."""
        b = fc_feats.shape[0]
        _, att, p_att = self._prep_feats(fc_feats, att_feats)
        h = att.new_zeros((b, self.rnn_size))
        c = h
        it = torch.zeros((b,), dtype=torch.long, device=att.device)
        done = torch.zeros((b,), dtype=torch.bool, device=att.device)
        seq, lps = [], []
        for _ in range(self.seq_length):
            logp, h, c = self._step_logp(it, att, p_att, h, c)
            lp, nxt = torch.max(logp, dim=-1)
            it = torch.where(done, 0, nxt)
            done = done | (it == 0)
            seq.append(it)
            lps.append(lp)
        return torch.stack(seq, 1), torch.stack(lps, 1)

    @torch.no_grad()
    def sample_beam(self, fc_feats, att_feats, beam_size: int = 10
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fixed-width beam search (reference CaptionModel.beam_search,
        CaptionModel.py:23-124), every row's beams in one batch: UNK (the
        last index) costs 1000, a finished beam extends with PAD at no
        cost. Returns (the best sequence (B, T) int64, its score (B,))."""
        b = fc_feats.shape[0]
        k, v1, r = beam_size, self.vocab_size + 1, self.rnn_size
        _, att, p_att = self._prep_feats(fc_feats, att_feats)
        dev = att.device
        att_b = att.repeat_interleave(k, dim=0)                # (B*K, L, R)
        p_b = p_att.repeat_interleave(k, dim=0)
        h = att.new_zeros((b * k, r))
        c = h
        it = torch.zeros((b * k,), dtype=torch.long, device=dev)
        seqs = torch.zeros((b, k, self.seq_length), dtype=torch.long,
                           device=dev)
        scores = torch.full((b, k), -1e9, device=dev)
        scores[:, 0] = 0.0
        done = torch.zeros((b, k), dtype=torch.bool, device=dev)
        pad_only = torch.full((v1,), -1e9, device=dev)
        pad_only[0] = 0.0
        unk = torch.zeros((v1,), device=dev)
        unk[v1 - 1] = -1000.0
        rows = torch.arange(b, device=dev)[:, None]
        for step in range(self.seq_length):
            logp, h, c = self._step_logp(it, att_b, p_b, h, c)
            logp = logp.reshape(b, k, v1) + unk
            logp = torch.where(done[..., None], pad_only, logp)
            cand = (scores[..., None] + logp).reshape(b, k * v1)
            # the k best, ties to the lowest index (lax.top_k's order)
            top, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
            scores, idx = top[:, :k], idx[:, :k]
            beam, word = idx // v1, idx % v1
            seqs = seqs[rows, beam]
            seqs[:, :, step] = word
            done = done[rows, beam] | (word == 0)
            flat = (rows * k + beam).reshape(-1)
            h, c, it = h[flat], c[flat], word.reshape(-1)
        best = torch.argmax(scores, dim=-1)
        return seqs[rows[:, 0], best], scores[rows[:, 0], best]
