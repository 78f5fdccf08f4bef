"""Caption decoder zoo and factory.

Counterpart of `lang2seg_tpu/models/caption_zoo.py` (reference
`lib/caption_models/__init__.py:16-52`, `ShowTellModel.py`, `FCModel.py`,
`AttModel.py:380-395`, `OldModel.py`, AdaAtt): the decoder named by
`cfg.model.caption_model`. `att2in2` / `att2in` is
`models/captioner.py::Att2In2Captioner`; the others are here:
  * `show_tell`: the fc feature through `img_embed` fed at step -1, then
    a plain LSTM over the words;
  * `fc`: the same with a ReLU `fc_embed`;
  * `topdown`: an attention LSTM over [h_lang, fc, word], additive
    attention keyed by its state, a language LSTM over [context, h_att];
  * `show_attend_tell` (alias `all_img`): one LSTM over [word, context],
    the context attended by the previous state;
  * `adaatt` (alias `adaattmo`): an LSTM with a visual sentinel, attention
    over the regions and the sentinel.

Each LSTM's gates are i, f, o, g along its 4 * rnn_size columns (not
torch's `nn.LSTM` order). The raw parameters keep the JAX package's names
and its (in, out) layout (`embed_w`, `i2h_w`, `att_ih`, `lang_b`,
`h2att_w`, ...), so `weights.from_jax_params` copies them as they are;
the JAX package's `nn.Dense` layers (`img_embed`, `fc_embed`,
`att_embed`, `ctx2att`) are `nn.Linear`. A raw `*_b` (or `b`) is a
weight for the SGD groups, as JAX's `_is_bias` reads its name; a
Linear's `.bias` is a bias.

These decoders are teacher-forced only, as in the JAX package (no greedy
or beam sampler, no scheduled sampling). `show_tell` and `fc` apply
dropout at `drop_prob_lm` in train mode to each step's word embedding and
LSTM output, drawn from the caller's `torch.Generator` in that order, step
by step (JAX's per-step key split k1, k2); the attention decoders have no
dropout, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from .captioner import Att2In2Captioner
from .lang_encoder import word_dropout


def _raw(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape))


def _lstm_cell(x, h, c, w_ih, w_hh, b):
    """One LSTM step over raw (in, 4R) weights, gates i, f, o, g."""
    r = h.shape[-1]
    s = x @ w_ih + h @ w_hh + b
    i = torch.sigmoid(s[:, :r])
    f = torch.sigmoid(s[:, r:2 * r])
    o = torch.sigmoid(s[:, 2 * r:3 * r])
    g = torch.tanh(s[:, 3 * r:])
    c2 = f * c + i * g
    return o * torch.tanh(c2), c2


def _attend(p_att, q, alpha_w):
    """Additive attention logits (B, L): (tanh(p_att + q) @ alpha_w)."""
    return (torch.tanh(p_att + q[:, None, :]) @ alpha_w)[..., 0]


class _ZooDecoder(nn.Module):
    """What the zoo's decoders share: the word embedding and logit
    layer, the masked-mean NLL and the train-mode arguments."""

    def __init__(self, vocab_size: int, seq_length: int, rnn_size: int,
                 input_encoding_size: int, drop_prob_lm: float):
        super().__init__()
        self.vocab_size = vocab_size
        self.seq_length = seq_length
        self.rnn_size = rnn_size
        self.drop_prob_lm = drop_prob_lm
        v1 = vocab_size + 1
        self.embed_w = _raw(v1, input_encoding_size)
        self.logit_w = _raw(rnn_size, v1)
        self.logit_b = _raw(v1)

    def _word(self, it):
        return F.relu(self.embed_w[it.long()])

    def _logp(self, outs):
        """(B, T, R) step outputs -> (B, T, V+1) log-probs."""
        return torch.log_softmax(outs @ self.logit_w + self.logit_b, dim=-1)

    def _check_train_args(self, generator, ss_prob):
        """The generator that draws dropout in train mode (None in eval
        mode or without dropout)."""
        if ss_prob:
            raise ValueError(f"caption model {type(self).__name__} has no "
                             f"scheduled sampling (ss_prob {ss_prob}), as in "
                             f"the JAX package")
        if not self.training or self.drop_prob_lm <= 0.0:
            return None
        if generator is None:
            raise ValueError(f"{type(self).__name__}: dropout in train mode "
                             f"needs a torch.Generator")
        return generator

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


class _LSTMDecoder(_ZooDecoder):
    """One raw LSTM fed an image embedding at step -1, then the words
    (ShowTell / FC structure)."""

    def __init__(self, vocab_size: int, seq_length: int, rnn_size: int,
                 input_encoding_size: int, drop_prob_lm: float):
        super().__init__(vocab_size, seq_length, rnn_size,
                         input_encoding_size, drop_prob_lm)
        r, e = rnn_size, input_encoding_size
        self.i2h_w = _raw(e, 4 * r)
        self.i2h_b = _raw(4 * r)
        self.h2h_w = _raw(r, 4 * r)
        self.h2h_b = _raw(4 * r)

    def _lstm(self, xt, h, c):
        return _lstm_cell(xt, h, c, self.i2h_w, self.h2h_w,
                          self.i2h_b + self.h2h_b)

    def _drop(self, x, generator):
        if generator is None:
            return x
        return word_dropout(x, self.drop_prob_lm, generator)

    def _run(self, img_emb, seq, generator):
        b = seq.shape[0]
        h = img_emb.new_zeros((b, self.rnn_size))
        h, c = self._lstm(img_emb, h, h)
        outs = []
        for i in range(seq.shape[1] - 1):
            xt = self._drop(self._word(seq[:, i]), generator)
            h, c = self._lstm(xt, h, c)
            outs.append(self._drop(h, generator))
        return self._logp(torch.stack(outs, dim=1))


class ShowTellCaptioner(_LSTMDecoder):
    """ShowTellModel.py: img_embed(fc) as step -1, a plain LSTM decoder."""

    def __init__(self, vocab_size: int, seq_length: int = 10,
                 rnn_size: int = 512, input_encoding_size: int = 512,
                 fc_feat_size: int = 4096, drop_prob_lm: float = 0.5):
        super().__init__(vocab_size, seq_length, rnn_size,
                         input_encoding_size, drop_prob_lm)
        self.img_embed = nn.Linear(fc_feat_size, input_encoding_size)

    def teacher_forced_logprobs(self, fc_feats, att_feats, seq,
                                generator: Optional[torch.Generator] = None,
                                ss_prob: Optional[float] = None
                                ) -> torch.Tensor:
        """seq: (B, T) with BOS = 0 at column 0 -> (B, T-1, V+1)."""
        gen = self._check_train_args(generator, ss_prob)
        return self._run(self.img_embed(fc_feats), seq, gen)


class FCCaptioner(_LSTMDecoder):
    """FCModel.py: the fc feature through a ReLU embed as step -1."""

    def __init__(self, vocab_size: int, seq_length: int = 10,
                 rnn_size: int = 512, input_encoding_size: int = 512,
                 fc_feat_size: int = 4096, drop_prob_lm: float = 0.5):
        super().__init__(vocab_size, seq_length, rnn_size,
                         input_encoding_size, drop_prob_lm)
        self.fc_embed = nn.Linear(fc_feat_size, input_encoding_size)

    def teacher_forced_logprobs(self, fc_feats, att_feats, seq,
                                generator: Optional[torch.Generator] = None,
                                ss_prob: Optional[float] = None
                                ) -> torch.Tensor:
        gen = self._check_train_args(generator, ss_prob)
        return self._run(F.relu(self.fc_embed(fc_feats)), seq, gen)


class _AttDecoder(_ZooDecoder):
    """The attention decoders' feature embeds: att_embed (ReLU) and the
    keys ctx2att, with fc_embed (ReLU) where the decoder reads fc."""

    def _embeds(self, fc_feat_size: Optional[int], att_feat_size: int,
                att_hid_size: int):
        """Registered after the raw parameters, in the JAX tree's order;
        `fc_feat_size` None for a decoder that does not read fc."""
        r = self.rnn_size
        self.use_fc = fc_feat_size is not None
        if self.use_fc:
            self.fc_embed = nn.Linear(fc_feat_size, r)
        self.att_embed = nn.Linear(att_feat_size, r)
        self.ctx2att = nn.Linear(r, att_hid_size)

    def _prep(self, fc_feats, att_feats):
        fc = F.relu(self.fc_embed(fc_feats)) if self.use_fc else None
        att = F.relu(self.att_embed(att_feats))
        return fc, att, self.ctx2att(att)


class TopDownCaptioner(_AttDecoder):
    """Bottom-up / top-down (reference TopDownCore, AttModel.py:380-395):
    the attention LSTM over [h_lang, fc, word], additive attention keyed
    by h_att, the language LSTM over [context, h_att]."""

    def __init__(self, vocab_size: int, seq_length: int = 10,
                 rnn_size: int = 512, input_encoding_size: int = 512,
                 att_hid_size: int = 512, fc_feat_size: int = 4096,
                 att_feat_size: int = 4096, drop_prob_lm: float = 0.5):
        super().__init__(vocab_size, seq_length, rnn_size,
                         input_encoding_size, drop_prob_lm)
        r, e, ah = rnn_size, input_encoding_size, att_hid_size
        self.att_ih = _raw(r + r + e, 4 * r)
        self.att_hh = _raw(r, 4 * r)
        self.att_b = _raw(4 * r)
        self.lang_ih = _raw(r + r, 4 * r)
        self.lang_hh = _raw(r, 4 * r)
        self.lang_b = _raw(4 * r)
        self.h2att_w = _raw(r, ah)
        self.h2att_b = _raw(ah)
        self.alpha_w = _raw(ah, 1)
        self._embeds(fc_feat_size, att_feat_size, att_hid_size)

    def teacher_forced_logprobs(self, fc_feats, att_feats, seq,
                                generator: Optional[torch.Generator] = None,
                                ss_prob: Optional[float] = None
                                ) -> torch.Tensor:
        self._check_train_args(generator, ss_prob)
        fc, att, p_att = self._prep(fc_feats, att_feats)
        z = fc.new_zeros((seq.shape[0], self.rnn_size))
        h_a = c_a = h_l = c_l = z
        outs = []
        for i in range(seq.shape[1] - 1):
            xt = self._word(seq[:, i])
            h_a, c_a = _lstm_cell(torch.cat([h_l, fc, xt], -1), h_a, c_a,
                                  self.att_ih, self.att_hh, self.att_b)
            w = torch.softmax(_attend(p_att, h_a @ self.h2att_w
                                      + self.h2att_b, self.alpha_w), dim=-1)
            att_res = torch.bmm(w[:, None, :], att)[:, 0]
            h_l, c_l = _lstm_cell(torch.cat([att_res, h_a], -1), h_l, c_l,
                                  self.lang_ih, self.lang_hh, self.lang_b)
            outs.append(h_l)
        return self._logp(torch.stack(outs, dim=1))


class ShowAttendTellCaptioner(_AttDecoder):
    """Show-attend-tell / all_img (reference OldModel.py): one LSTM whose
    input is the word embedding and a context attended by the previous
    hidden state."""

    def __init__(self, vocab_size: int, seq_length: int = 10,
                 rnn_size: int = 512, input_encoding_size: int = 512,
                 att_hid_size: int = 512, fc_feat_size: int = 4096,
                 att_feat_size: int = 4096, drop_prob_lm: float = 0.5):
        super().__init__(vocab_size, seq_length, rnn_size,
                         input_encoding_size, drop_prob_lm)
        r, e, ah = rnn_size, input_encoding_size, att_hid_size
        self.ih = _raw(e + r, 4 * r)
        self.hh = _raw(r, 4 * r)
        self.b = _raw(4 * r)
        self.h2att_w = _raw(r, ah)
        self.alpha_w = _raw(ah, 1)
        self._embeds(None, att_feat_size, att_hid_size)

    def teacher_forced_logprobs(self, fc_feats, att_feats, seq,
                                generator: Optional[torch.Generator] = None,
                                ss_prob: Optional[float] = None
                                ) -> torch.Tensor:
        self._check_train_args(generator, ss_prob)
        _, att, p_att = self._prep(fc_feats, att_feats)
        h = c = att.new_zeros((seq.shape[0], self.rnn_size))
        outs = []
        for i in range(seq.shape[1] - 1):
            w = torch.softmax(_attend(p_att, h @ self.h2att_w, self.alpha_w),
                              dim=-1)
            ctx = torch.bmm(w[:, None, :], att)[:, 0]
            xt = torch.cat([self._word(seq[:, i]), ctx], -1)
            h, c = _lstm_cell(xt, h, c, self.ih, self.hh, self.b)
            outs.append(h)
        return self._logp(torch.stack(outs, dim=1))


class AdaAttCaptioner(_AttDecoder):
    """Adaptive attention with a visual sentinel (reference AdaAttModel /
    AdaAttMO): the LSTM keeps a sentinel s_t = sigmoid(W [x, h]) *
    tanh(c_t); attention runs over the regions and the sentinel."""

    def __init__(self, vocab_size: int, seq_length: int = 10,
                 rnn_size: int = 512, input_encoding_size: int = 512,
                 att_hid_size: int = 512, fc_feat_size: int = 4096,
                 att_feat_size: int = 4096, drop_prob_lm: float = 0.5):
        super().__init__(vocab_size, seq_length, rnn_size,
                         input_encoding_size, drop_prob_lm)
        r, e, ah = rnn_size, input_encoding_size, att_hid_size
        self.ih = _raw(e + r, 4 * r)
        self.hh = _raw(r, 4 * r)
        self.b = _raw(4 * r)
        self.sent_x = _raw(e + r, r)
        self.sent_h = _raw(r, r)
        self.h2att_w = _raw(r, ah)
        self.s2att_w = _raw(r, ah)
        self.alpha_w = _raw(ah, 1)
        self._embeds(fc_feat_size, att_feat_size, att_hid_size)

    def teacher_forced_logprobs(self, fc_feats, att_feats, seq,
                                generator: Optional[torch.Generator] = None,
                                ss_prob: Optional[float] = None
                                ) -> torch.Tensor:
        self._check_train_args(generator, ss_prob)
        fc, att, p_att = self._prep(fc_feats, att_feats)
        h = c = att.new_zeros((seq.shape[0], self.rnn_size))
        outs = []
        for i in range(seq.shape[1] - 1):
            xt = torch.cat([self._word(seq[:, i]), fc], -1)
            h_prev = h
            h, c = _lstm_cell(xt, h_prev, c, self.ih, self.hh, self.b)
            s = torch.sigmoid(xt @ self.sent_x + h_prev @ self.sent_h) \
                * torch.tanh(c)                                  # sentinel
            q = h @ self.h2att_w
            e_r = _attend(p_att, q, self.alpha_w)                # (B, L)
            e_s = torch.tanh(s @ self.s2att_w + q) @ self.alpha_w   # (B, 1)
            w = torch.softmax(torch.cat([e_r, e_s], -1), dim=-1)
            ctx = torch.bmm(w[:, None, :-1], att)[:, 0] + w[:, -1:] * s
            outs.append(h + ctx)
        return self._logp(torch.stack(outs, dim=1))


ZOO = {"show_tell": ShowTellCaptioner, "fc": FCCaptioner,
       "topdown": TopDownCaptioner,
       "show_attend_tell": ShowAttendTellCaptioner,
       "all_img": ShowAttendTellCaptioner, "adaatt": AdaAttCaptioner,
       "adaattmo": AdaAttCaptioner}


def setup_captioner(m: ModelConfig) -> nn.Module:
    """The decoder named by m.caption_model (caption_models/__init__.py:
    16-52)."""
    name = m.caption_model
    common = dict(vocab_size=m.cap_vocab_size, seq_length=m.cap_seq_length,
                  rnn_size=m.cap_rnn_size,
                  input_encoding_size=m.cap_input_encoding_size,
                  fc_feat_size=m.cap_fc_feat_size,
                  drop_prob_lm=m.cap_drop_prob_lm)
    if name in ("att2in2", "att2in"):
        return Att2In2Captioner(att_hid_size=m.cap_att_hid_size,
                                att_feat_size=m.cap_att_feat_size,
                                ss_prob=m.cap_scheduled_sampling_prob,
                                **common)
    if name not in ZOO:
        raise ValueError(f"unknown caption model {name}")
    cls = ZOO[name]
    if issubclass(cls, _AttDecoder):
        common.update(att_hid_size=m.cap_att_hid_size,
                      att_feat_size=m.cap_att_feat_size)
    return cls(**common)
