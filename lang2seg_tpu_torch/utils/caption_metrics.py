"""Caption evaluation metrics: BLEU-1..4, ROUGE_L, CIDEr and METEOR.

The port's own copy of `lang2seg_tpu/utils/caption_metrics.py` (pure
Python, the same operations in the same order, so every score is the
same float), the counterpart of the reference's caption-metric stack
(`pyutils/refer/evaluation/refEvaluation.py:17-60` +
`evaluation/{bleu,cider,meteor,rouge,tokenizer}/`): PTB-style
tokenization, BLEU-1..4 (corpus-level, closest-reference brevity
penalty), ROUGE_L (F-beta with beta=1.2), CIDEr (TF-IDF weighted n-gram
cosine, n=1..4, sigma=6 length gaussian), METEOR.

The reference shells out to Stanford's PTB tokenizer jar and the METEOR
1.5 jar; here the PTB tokenization rules are Python and METEOR is the
exact+stem alignment variant, with an OPTIONAL synonymy stage: point
LANG2SEG_METEOR_SYNSETS at a synonym-set file (or pass
meteor(synonyms=load_synonyms(path))) to enable METEOR 1.5's third
module. Without synonym data the METEOR score is a lower bound; the
other three metrics are algorithm-exact.
"""

from __future__ import annotations

import functools
import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

# ---------- tokenizer ----------

_PUNCT = r"""!"#$%&()*+,./:;<=>?@\[\]^_`{|}~"""


def ptb_tokenize(s: str) -> List[str]:
    """PTB-style lowercase word tokenization (the reference uses the
    Stanford PTBTokenizer jar with punctuation stripped)."""
    s = s.lower()
    s = re.sub(r"[{}]".format(re.escape(_PUNCT)), " ", s)
    s = re.sub(r"'s\b", " 's", s)
    s = re.sub(r"n't\b", " n't", s)
    s = re.sub(r"\s+", " ", s).strip()
    return s.split()


# ---------- n-gram helpers ----------

def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------- BLEU ----------

def bleu(candidates: List[List[str]], references: List[List[List[str]]],
         max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n with closest-length brevity penalty
    (algorithm of the reference's bleu scorer)."""
    assert len(candidates) == len(references)
    clipped = [0] * max_n
    total = [0] * max_n
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        cand_len += len(cand)
        ref_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            cg = _ngrams(cand, n)
            max_ref = Counter()
            for r in refs:
                rg = _ngrams(r, n)
                for g, c in rg.items():
                    max_ref[g] = max(max_ref[g], c)
            total[n - 1] += max(len(cand) - n + 1, 0)
            clipped[n - 1] += sum(min(c, max_ref[g]) for g, c in cg.items())
    bp = 1.0 if cand_len > ref_len else math.exp(
        1 - ref_len / max(cand_len, 1))
    out = []
    logsum = 0.0
    for n in range(max_n):
        p = clipped[n] / total[n] if total[n] > 0 else 0.0
        logsum += math.log(max(p, 1e-12))
        out.append(bp * math.exp(logsum / (n + 1)))
    return out


# ---------- ROUGE-L ----------

def _lcs(a: Sequence[str], b: Sequence[str]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(candidates: List[List[str]],
            references: List[List[List[str]]], beta: float = 1.2) -> float:
    """Mean sentence ROUGE-L F-beta over max-per-reference P/R."""
    scores = []
    for cand, refs in zip(candidates, references):
        prec, rec = [], []
        for r in refs:
            l = _lcs(cand, r)
            prec.append(l / max(len(cand), 1))
            rec.append(l / max(len(r), 1))
        p, r_ = max(prec), max(rec)
        if p + r_ > 0:
            scores.append(((1 + beta ** 2) * p * r_)
                          / (r_ + beta ** 2 * p))
        else:
            scores.append(0.0)
    return sum(scores) / max(len(scores), 1)


# ---------- CIDEr ----------

def cider(candidates: List[List[str]],
          references: List[List[List[str]]], max_n: int = 4,
          sigma: float = 6.0) -> float:
    """CIDEr-D style TF-IDF n-gram cosine with length gaussian."""
    num = len(candidates)
    # document frequency over reference sets
    df: Dict[int, Counter] = {n: Counter() for n in range(1, max_n + 1)}
    for refs in references:
        for n in range(1, max_n + 1):
            seen = set()
            for r in refs:
                seen |= set(_ngrams(r, n).keys())
            for g in seen:
                df[n][g] += 1
    log_num = math.log(max(num, 1))

    def tfidf_vec(tokens, n):
        cnt = _ngrams(tokens, n)
        total = sum(cnt.values())
        vec = {}
        for g, c in cnt.items():
            idf = log_num - math.log(max(df[n][g], 1))
            vec[g] = (c / max(total, 1)) * idf
        return vec

    def cos(v1, v2, len1, len2):
        if not v1 or not v2:
            return 0.0
        common = set(v1) & set(v2)
        # CIDEr-D: clip candidate counts at reference counts
        numer = sum(min(v1[g], v2[g]) * v2[g] for g in common)
        n1 = math.sqrt(sum(x * x for x in v1.values()))
        n2 = math.sqrt(sum(x * x for x in v2.values()))
        if n1 == 0 or n2 == 0:
            return 0.0
        delta = len1 - len2
        return (numer / (n1 * n2)) * math.exp(-delta * delta
                                              / (2 * sigma ** 2))

    scores = []
    for cand, refs in zip(candidates, references):
        s = 0.0
        for n in range(1, max_n + 1):
            vc = tfidf_vec(cand, n)
            sn = sum(cos(vc, tfidf_vec(r, n), len(cand), len(r))
                     for r in refs) / max(len(refs), 1)
            s += sn
        scores.append(10.0 * s / max_n)
    return sum(scores) / max(len(scores), 1)


# ---------- METEOR (exact+stem variant) ----------

def _porter_light(w: str) -> str:
    """Light stemmer (suffix stripping) for METEOR's stem module."""
    for suf in ("ing", "ed", "es", "s", "ly"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[:len(w) - len(suf)]
    return w


@functools.lru_cache(maxsize=4)
def load_synonyms(path: str) -> Dict[str, frozenset]:
    """Load a synonym-set file for METEOR's synonymy stage: one synonym
    group per line, words space-separated (the data equivalent of METEOR
    1.5's WordNet synsets module, meteor-1.5/data/english.synsets — the
    WordNet data itself is not shipped in this image; point
    LANG2SEG_METEOR_SYNSETS at a file to enable the stage).
    Returns word -> frozenset of group ids (a word may appear in several
    groups)."""
    groups: Dict[str, set] = defaultdict(set)
    with open(path) as f:
        for gid, line in enumerate(f):
            for w in line.split():
                groups[w.lower()].add(gid)
    return {w: frozenset(g) for w, g in groups.items()}


def _env_synonyms():
    import os
    p = os.environ.get("LANG2SEG_METEOR_SYNSETS")
    if p and os.path.exists(p):
        return load_synonyms(p)
    return None


def meteor(candidates: List[List[str]],
           references: List[List[List[str]]], alpha: float = 0.9,
           beta: float = 3.0, gamma: float = 0.5,
           synonyms: Dict[str, frozenset] = None) -> float:
    """METEOR with exact + stem (+ optional synonymy) matching stages.
    Per-sentence max over references, corpus mean. `synonyms` (see
    load_synonyms) enables the reference jar's third stage
    (meteor/meteor.py drives METEOR 1.5 with exact/stem/synonym);
    without data the score is a documented lower bound."""
    if synonyms is None:
        synonyms = _env_synonyms()
    stages = [
        lambda a, b: a == b,
        lambda a, b: _porter_light(a) == _porter_light(b),
    ]
    if synonyms:
        empty = frozenset()
        stages.append(lambda a, b: bool(synonyms.get(a, empty)
                                        & synonyms.get(b, empty)))

    def align(cand, ref):
        matches: List[Tuple[int, int]] = []
        used_r = set()
        for stage in stages:
            for i, cw in enumerate(cand):
                if any(m[0] == i for m in matches):
                    continue
                for j, rw in enumerate(ref):
                    if j in used_r:
                        continue
                    if stage(cw, rw):
                        matches.append((i, j))
                        used_r.add(j)
                        break
        if not matches:
            return 0.0
        m = len(matches)
        p = m / len(cand)
        r = m / len(ref)
        fmean = p * r / (alpha * p + (1 - alpha) * r)
        # chunks: contiguous in both
        matches.sort()
        chunks = 1
        for (i1, j1), (i2, j2) in zip(matches, matches[1:]):
            if i2 != i1 + 1 or j2 != j1 + 1:
                chunks += 1
        penalty = gamma * (chunks / m) ** beta
        return fmean * (1 - penalty)

    scores = [max(align(c, r) for r in refs) if refs else 0.0
              for c, refs in zip(candidates, references)]
    return sum(scores) / max(len(scores), 1)


# ---------- RefEvaluation facade ----------

class RefEvaluation:
    """Parity with the reference's RefEvaluation
    (evaluation/refEvaluation.py:17-60): takes refs with gt 'sentences'
    and predictions [{'ref_id', 'sent'}], tokenizes, runs all metrics,
    fills eval / refToEval tables."""

    def __init__(self, refs: List[Dict], preds: List[Dict]):
        self.refs = {r["ref_id"]: r for r in refs}
        self.preds = preds
        self.eval: Dict[str, float] = {}
        self.refToEval: Dict = {}

    def evaluate(self) -> Dict[str, float]:
        cands, refs_tok, ref_ids = [], [], []
        for p in self.preds:
            rid = p["ref_id"]
            gt = self.refs[rid]
            cands.append(ptb_tokenize(p["sent"]))
            refs_tok.append([ptb_tokenize(s["sent"])
                             for s in gt["sentences"]])
            ref_ids.append(rid)

        b = bleu(cands, refs_tok)
        for i, v in enumerate(b, 1):
            self.eval[f"Bleu_{i}"] = v
        self.eval["ROUGE_L"] = rouge_l(cands, refs_tok)
        self.eval["CIDEr"] = cider(cands, refs_tok)
        self.eval["METEOR"] = meteor(cands, refs_tok)
        for rid, c, rt in zip(ref_ids, cands, refs_tok):
            self.refToEval[rid] = {
                "ROUGE_L": rouge_l([c], [rt]),
                "CIDEr": cider([c], [rt]),
                "METEOR": meteor([c], [rt]),
            }
        return self.eval
