"""Caption decoder factory.

Counterpart of `lang2seg_tpu/models/caption_zoo.py::setup_captioner`
(reference `lib/caption_models/__init__.py:16-52`): the decoder named by
`cfg.model.caption_model`. Ported: `att2in2` and its alias `att2in`
(`models/captioner.py`). The other decoders of the JAX zoo (`show_tell`,
`fc`, `topdown`, `show_attend_tell`, `adaatt`) raise NotImplementedError.
"""

from __future__ import annotations

from ..config import ModelConfig
from .captioner import Att2In2Captioner

NOT_PORTED = ("show_tell", "fc", "topdown", "show_attend_tell", "all_img",
              "adaatt", "adaattmo")


def setup_captioner(m: ModelConfig) -> Att2In2Captioner:
    name = m.caption_model
    if name in ("att2in2", "att2in"):
        return Att2In2Captioner(
            vocab_size=m.cap_vocab_size, seq_length=m.cap_seq_length,
            rnn_size=m.cap_rnn_size,
            input_encoding_size=m.cap_input_encoding_size,
            att_hid_size=m.cap_att_hid_size,
            fc_feat_size=m.cap_fc_feat_size,
            att_feat_size=m.cap_att_feat_size,
            drop_prob_lm=m.cap_drop_prob_lm,
            ss_prob=m.cap_scheduled_sampling_prob)
    if name in NOT_PORTED:
        raise NotImplementedError(f"caption model {name!r} is not ported")
    raise ValueError(f"unknown caption model {name}")
