"""Offline preprocessing: REFER -> data.json + data.h5. The port's copy of
`lang2seg_tpu/data/prepro.py`.

The reference's `tools/prepro.py:46-291`: vocabulary = words with count
> threshold (default 5) + COCO category words (+'__background__') +
<UNK> (if any rare words) + <BOS> + <EOS>, with <PAD> at index 0; labels
= int32 (M, max_length) zero-padded, max_length 10 (refcoco/+) or 20
(refcocog); per-ref compressed RLE cached in the json; images/anns/
sentences/refs tables with h5_id linking sentences to label rows.
`prepro_data` builds both in memory; `run_prepro` writes them (h5py is
imported only there).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_MAX_LENGTH = {"refcoco": 10, "refcoco+": 10, "refcocog": 20,
                      "refclef": 10}


def build_vocab(refer, count_threshold: int = 5):
    """Returns (vocab list with <PAD> first, sent_id -> final tokens)."""
    word2count: Dict[str, int] = {}
    for tokens in refer.sentToTokens.values():
        for wd in tokens:
            word2count[wd] = word2count.get(wd, 0) + 1

    good = [wd for wd, n in word2count.items() if n > count_threshold]
    bad_count = sum(n for wd, n in word2count.items()
                    if n <= count_threshold)
    vocab = list(good)

    cat_names = list(refer.Cats.values()) + ["__background__"]
    for name in cat_names:
        for wd in name.split():
            if word2count.get(wd, 0) <= count_threshold:
                word2count[wd] = 100000
                vocab.append(wd)

    if bad_count > 0:
        vocab.append("<UNK>")
    vocab.append("<BOS>")
    vocab.append("<EOS>")
    vocab.insert(0, "<PAD>")

    sent_to_final = {
        sid: [wd if word2count.get(wd, 0) > count_threshold else "<UNK>"
              for wd in tokens]
        for sid, tokens in refer.sentToTokens.items()}
    return vocab, sent_to_final


def build_att_vocab(att_json_path: str, top_k: int = 50):
    """Attribute vocabulary from refer-parser2 output (reference
    build_att_vocab, prepro.py:190-229): counts attribute words per ref,
    keeps the top-k, returns (att_to_ix, ref_to_att_wds). The parsed-
    attribute json is an external input ({ref_id: [att_wd, ...]})."""
    with open(att_json_path) as f:
        ref_to_atts = {int(k): v for k, v in json.load(f).items()}
    counts: Dict[str, int] = {}
    for wds in ref_to_atts.values():
        for wd in wds:
            counts[wd] = counts.get(wd, 0) + 1
    top = sorted(counts, key=lambda w: -counts[w])[:top_k]
    att_to_ix = {w: i for i, w in enumerate(top)}
    kept = {rid: [w for w in wds if w in att_to_ix]
            for rid, wds in ref_to_atts.items()}
    return att_to_ix, kept


def encode_labels(sentences: List[Dict], wtoi: Dict[str, int],
                  max_length: int) -> np.ndarray:
    labels = np.zeros((len(sentences), max_length), np.int32)
    for i, sent in enumerate(sentences):
        assert sent["h5_id"] == i
        for j, w in enumerate(sent["tokens"][:max_length]):
            labels[i, j] = wtoi[w]
    return labels


def prepare_json(refer, sent_to_final) -> Dict:
    """Build the data.json tables (reference prepare_json,
    prepro.py:135-189): refs (with cached RLE), images, anns, sentences
    (h5_id assigned in enumeration order), categories."""
    images, anns, refs, sentences = [], [], [], []
    h5_id = 0
    for img_id in refer.getImgIds():
        img = refer.Imgs[img_id]
        images.append({
            "image_id": img_id, "file_name": img["file_name"],
            "width": img["width"], "height": img["height"],
            "ref_ids": [r["ref_id"] for r in refer.imgToRefs.get(img_id, [])],
            "ann_ids": [a["id"] for a in refer.imgToAnns.get(img_id, [])]})
    for ann in refer.anns_data:
        anns.append({"ann_id": ann["id"], "category_id": ann["category_id"],
                     "image_id": ann["image_id"], "box": ann["bbox"]})
    for ref in refer.refs_data:
        box = refer.Anns[ref["ann_id"]]["bbox"]
        refs.append({
            "ref_id": ref["ref_id"], "ann_id": ref["ann_id"],
            "image_id": ref["image_id"], "split": ref["split"],
            "category_id": ref["category_id"], "box": box,
            "rle": refer.getRefRLE(ref),
            "sent_ids": ref["sent_ids"]})
        for s in ref["sentences"]:
            sentences.append({"sent_id": s["sent_id"],
                              "tokens": sent_to_final[s["sent_id"]],
                              "h5_id": h5_id})
            h5_id += 1
    return {"images": images, "anns": anns, "refs": refs,
            "sentences": sentences}


def prepro_data(refer, max_length: int, count_threshold: int = 5,
                att_json: Optional[str] = None,
                att_top_k: int = 50) -> Tuple[Dict, np.ndarray]:
    """(data.json dict, (N, max_length) int32 labels) of a loaded REFER
    (reference prepro.py:231-291, without the files).

    att_json: optional refer-parser2 attribute file ({ref_id: [att_wd]});
    when given, the top-k attribute vocab (att_to_ix) and per-ref att_wds
    go into the dict (reference build_att_vocab, prepro.py:190-229)."""
    vocab, sent_to_final = build_vocab(refer, count_threshold)
    wtoi = {w: i for i, w in enumerate(vocab)}
    data = prepare_json(refer, sent_to_final)
    labels = encode_labels(data["sentences"], wtoi, max_length)

    out = dict(data)
    out["word_to_ix"] = wtoi
    out["ix_to_word"] = {str(i): w for i, w in enumerate(vocab)}
    out["cat_to_ix"] = {refer.Cats[cid]: cid for cid in refer.Cats}
    out["ix_to_cat"] = {str(cid): refer.Cats[cid] for cid in refer.Cats}

    if att_json is not None:
        att_to_ix, ref_atts = build_att_vocab(att_json, att_top_k)
        out["att_to_ix"] = att_to_ix
        for r in out["refs"]:
            r["att_wds"] = ref_atts.get(r["ref_id"], [])
    return out, labels


def run_prepro(data_root: str, dataset: str, split_by: str,
               output_dir: str, max_length: Optional[int] = None,
               count_threshold: int = 5, att_json: Optional[str] = None,
               att_top_k: int = 50) -> Tuple[str, str]:
    """Full pipeline: REFER -> <output_dir>/data.json + data.h5
    (reference prepro.py:231-291). Returns the two paths."""
    from .refer import REFER

    if max_length is None:
        max_length = DEFAULT_MAX_LENGTH.get(dataset, 10)
    refer = REFER(data_root, dataset, split_by)
    out, labels = prepro_data(refer, max_length, count_threshold, att_json,
                              att_top_k)

    os.makedirs(output_dir, exist_ok=True)
    json_path = os.path.join(output_dir, "data.json")
    h5_path = os.path.join(output_dir, "data.h5")
    with open(json_path, "w") as f:
        json.dump(out, f)
    import h5py
    with h5py.File(h5_path, "w") as f:
        f.create_dataset("labels", data=labels)
    return json_path, h5_path
