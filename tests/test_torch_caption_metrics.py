"""The port's caption metrics (`lang2seg_tpu_torch/utils/caption_metrics.py`)
against the JAX package's copy: every score the same float, on the JAX
tests' cases and on seeded random sentences, with and without a METEOR
synonym file (passed, or through LANG2SEG_METEOR_SYNSETS)."""

import numpy as np
import pytest

from lang2seg_tpu.utils import caption_metrics as jm
from lang2seg_tpu_torch.utils import caption_metrics as pm

WORDS = ("the", "a", "man", "men", "woman", "dog", "dogs", "red", "big",
         "large", "small", "tiny", "left", "right", "running", "runs",
         "sitting", "on", "of", "chair", "chairs", "quickly", "white")
SYNSETS = "big large huge\nsmall tiny little\nman guy\nman person\n"


def random_corpus(seed, n=12, max_refs=4):
    """(candidates, references) of seeded random sentences, some empty,
    some repeated words."""
    r = np.random.RandomState(seed)

    def sent(lo=0):
        return [WORDS[i] for i in r.randint(0, len(WORDS), r.randint(lo, 9))]
    cands = [sent() for _ in range(n)]
    refs = [[sent(1) for _ in range(r.randint(1, max_refs + 1))]
            for _ in range(n)]
    return cands, refs


CASES = [
    ([["the", "big", "red", "dog"]], [[["the", "big", "red", "dog"]]]),
    ([["the", "red", "cat"]], [[["the", "red", "dog"]]]),
    ([["the"]], [[["the", "red", "dog"]]]),
    ([["the", "red", "dog"], ["a", "big", "cat"]],
     [[["the", "red", "dog"]], [["a", "big", "cat"]]]),
    ([["something", "else", "entirely"], ["nothing", "matches", "here"]],
     [[["the", "red", "dog"]], [["a", "big", "cat"]]]),
    ([["the", "dog", "red", "runs"]], [[["the", "red", "dog", "runs"]]]),
    ([["the", "dog", "runs"]], [[["the", "dog", "running"]]]),
    ([["the", "large", "dog"]], [[["the", "big", "dog"]]]),
    ([[]], [[["left", "person"]]]),
] + [random_corpus(s) for s in range(6)]


def _same(a, b):
    """The same float (or list of floats), bit for bit."""
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and (a == b or (a != a and b != b))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_metrics_equal_jax(case):
    cands, refs = CASES[case]
    for name in ("bleu", "rouge_l", "cider"):
        got = getattr(pm, name)(cands, refs)
        want = getattr(jm, name)(cands, refs)
        assert _same(got, want), (name, got, want)
    assert _same(pm.meteor(cands, refs, synonyms={}),
                 jm.meteor(cands, refs, synonyms={}))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_meteor_with_synonyms_equal_jax(case, tmp_path):
    """The synonymy stage from a file: passed, and through the
    environment switch; without the switch, the file-less score."""
    p = tmp_path / "synsets.txt"
    p.write_text(SYNSETS)
    syn_p, syn_j = pm.load_synonyms(str(p)), jm.load_synonyms(str(p))
    assert syn_p == syn_j
    cands, refs = CASES[case]
    assert _same(pm.meteor(cands, refs, synonyms=syn_p),
                 jm.meteor(cands, refs, synonyms=syn_j))


def test_meteor_env_switch(tmp_path, monkeypatch):
    p = tmp_path / "synsets.txt"
    p.write_text(SYNSETS)
    cands, refs = [["the", "large", "guy"]], [[["the", "big", "man"]]]
    monkeypatch.delenv("LANG2SEG_METEOR_SYNSETS", raising=False)
    base = pm.meteor(cands, refs)
    assert _same(base, jm.meteor(cands, refs))
    monkeypatch.setenv("LANG2SEG_METEOR_SYNSETS", str(p))
    with_syn = pm.meteor(cands, refs)
    assert _same(with_syn, jm.meteor(cands, refs))
    assert with_syn > base
    monkeypatch.setenv("LANG2SEG_METEOR_SYNSETS", str(tmp_path / "none"))
    assert _same(pm.meteor(cands, refs), base)


def test_tokenizer_lcs_and_stemmer_equal_jax():
    for s in ("The left-most dog, sitting!", "man's hat", "isn't it?",
              "  two   spaces ", "A \"quoted\" (word) [x] {y}; z:w",
              "", "L'homme's cat's"):
        assert pm.ptb_tokenize(s) == jm.ptb_tokenize(s), s
    for a, b in (("abcde", "ace"), ("", "abc"), ("abab", "baba")):
        assert pm._lcs(a, b) == jm._lcs(a, b)
    for w in WORDS + ("ed", "sing", "flies", "happily"):
        assert pm._porter_light(w) == jm._porter_light(w), w


@pytest.mark.parametrize("seed", [0, 1])
def test_ref_evaluation_equal_jax(seed, monkeypatch):
    """RefEvaluation: the corpus table and each ref's table the same
    floats; gt sentences as raw strings with punctuation and case."""
    monkeypatch.delenv("LANG2SEG_METEOR_SYNSETS", raising=False)
    cands, refs = random_corpus(100 + seed, n=8)
    gt = [{"ref_id": 10 + i, "sentences": [
        {"sent": " ".join(r).capitalize() + "."} for r in rs]}
        for i, rs in enumerate(refs)]
    preds = [{"ref_id": 10 + i, "sent": " ".join(c) + "!"}
             for i, c in enumerate(cands)]
    ev_p, ev_j = pm.RefEvaluation(gt, preds), jm.RefEvaluation(gt, preds)
    got, want = ev_p.evaluate(), ev_j.evaluate()
    assert list(got) == list(want) == [
        "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr",
        "METEOR"]
    for k in want:
        assert _same(got[k], want[k]), k
    assert ev_p.refToEval.keys() == ev_j.refToEval.keys()
    for rid, table in ev_j.refToEval.items():
        for k, v in table.items():
            assert _same(ev_p.refToEval[rid][k], v), (rid, k)
