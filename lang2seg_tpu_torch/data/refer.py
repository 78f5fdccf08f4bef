"""REFER dataset API: the port's copy of `lang2seg_tpu/data/refer.py`.

The reference's `pyutils/refer/refer.py:43-360`: loads
`refs(<splitBy>).p` (pickled ref records) + `instances.json` (COCO
format) for refcoco / refcoco+ / refcocog / refclef, builds the cross
indices (Refs, Anns, Imgs, Cats, Sents, imgToRefs, annToRef, ...),
filters by split, and converts annotation segmentations to binary masks
and compressed RLEs through the port's NumPy codec (data/rle.py).
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Dict, List

import numpy as np

from . import rle as rle_codec


class REFER:
    def __init__(self, data_root: str, dataset: str = "refcoco",
                 split_by: str = "unc"):
        print(f"loading dataset {dataset} into memory...")
        tic = time.time()
        self.data_dir = os.path.join(data_root, dataset)
        if dataset in ("refcoco", "refcoco+", "refcocog"):
            self.image_dir = os.path.join(data_root, "images", "train2014")
        elif dataset == "refclef":
            self.image_dir = os.path.join(data_root, "images", "saiapr_tc-12")
        else:
            raise ValueError(f"no dataset {dataset}")

        ref_file = os.path.join(self.data_dir, f"refs({split_by}).p")
        with open(ref_file, "rb") as f:
            self.refs_data: List[Dict] = pickle.load(f)

        with open(os.path.join(self.data_dir, "instances.json")) as f:
            instances = json.load(f)
        self.anns_data = instances["annotations"]
        self.imgs_data = instances["images"]
        self.cats_data = instances["categories"]

        self._build_index()
        print(f"DONE (t={time.time() - tic:.2f}s)")

    def _build_index(self):
        self.Anns = {a["id"]: a for a in self.anns_data}
        self.Imgs = {i["id"]: i for i in self.imgs_data}
        self.Cats = {c["id"]: c["name"] for c in self.cats_data}
        self.Refs = {r["ref_id"]: r for r in self.refs_data}

        self.imgToAnns: Dict = {}
        for a in self.anns_data:
            self.imgToAnns.setdefault(a["image_id"], []).append(a)

        self.imgToRefs: Dict = {}
        self.annToRef: Dict = {}
        self.catToRefs: Dict = {}
        self.Sents: Dict = {}
        self.sentToRef: Dict = {}
        self.sentToTokens: Dict = {}
        for r in self.refs_data:
            self.imgToRefs.setdefault(r["image_id"], []).append(r)
            self.annToRef[r["ann_id"]] = r
            self.catToRefs.setdefault(r["category_id"], []).append(r)
            for s in r["sentences"]:
                self.Sents[s["sent_id"]] = s
                self.sentToRef[s["sent_id"]] = r
                self.sentToTokens[s["sent_id"]] = s["tokens"]

    # ---------- queries (reference refer.py:141-275) ----------

    def getRefIds(self, image_ids=None, cat_ids=None, ref_ids=None,
                  split: str = "") -> List[int]:
        image_ids = _as_list(image_ids)
        cat_ids = _as_list(cat_ids)
        ref_ids = _as_list(ref_ids)

        refs = self.refs_data
        if image_ids:
            refs = [r for iid in image_ids for r in self.imgToRefs.get(iid, [])]
        if cat_ids:
            refs = [r for r in refs if r["category_id"] in cat_ids]
        if ref_ids:
            refs = [r for r in refs if r["ref_id"] in ref_ids]
        if split:
            if split in ("testA", "testB", "testC"):
                refs = [r for r in refs if split[-1] in r["split"]]
            elif split in ("testAB", "testBC", "testAC"):
                refs = [r for r in refs if r["split"] == split]
            elif split == "test":
                refs = [r for r in refs if "test" in r["split"]]
            elif split in ("train", "val"):
                refs = [r for r in refs if r["split"] == split]
            else:
                raise ValueError(f"no such split {split}")
        return [r["ref_id"] for r in refs]

    def getAnnIds(self, image_ids=None, cat_ids=None, ref_ids=None):
        image_ids = _as_list(image_ids)
        cat_ids = _as_list(cat_ids)
        ref_ids = _as_list(ref_ids)
        if image_ids:
            anns = [a for iid in image_ids
                    for a in self.imgToAnns.get(iid, [])]
        else:
            anns = self.anns_data
        if cat_ids:
            anns = [a for a in anns if a["category_id"] in cat_ids]
        ids = [a["id"] for a in anns]
        if ref_ids:
            ref_ann = set(self.Refs[rid]["ann_id"] for rid in ref_ids)
            ids = [i for i in ids if i in ref_ann]
        return ids

    def getImgIds(self, ref_ids=None) -> List[int]:
        ref_ids = _as_list(ref_ids)
        if ref_ids:
            return list({self.Refs[rid]["image_id"] for rid in ref_ids})
        return list(self.Imgs.keys())

    def getCatIds(self):
        return list(self.Cats.keys())

    def loadRefs(self, ref_ids) -> List[Dict]:
        return [self.Refs[r] for r in _as_list(ref_ids)]

    def loadAnns(self, ann_ids) -> List[Dict]:
        return [self.Anns[a] for a in _as_list(ann_ids)]

    def loadImgs(self, image_ids) -> List[Dict]:
        return [self.Imgs[i] for i in _as_list(image_ids)]

    # ---------- masks (reference refer.py:276-330) ----------

    def getMask(self, ref: Dict) -> Dict:
        """Binary mask + area for a ref's annotation. Returns
        {'mask': (h, w) uint8, 'area': float}."""
        ann = self.Anns[ref["ann_id"]]
        img = self.Imgs[ref["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            r = rle_codec.fr_poly(segm, h, w)
        elif isinstance(segm["counts"], list):
            r = rle_codec.fr_uncompressed(segm)
        else:
            r = segm
        m = rle_codec.decode(r)
        if m.ndim == 3:
            m = (m.sum(axis=2) > 0).astype(np.uint8)
        return {"mask": m.astype(np.uint8), "area": float(m.sum())}

    def getRefRLE(self, ref: Dict) -> Dict:
        """Compressed RLE for a ref (what prepro caches per ref)."""
        ann = self.Anns[ref["ann_id"]]
        img = self.Imgs[ref["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            r = rle_codec.fr_poly(segm, h, w)
        elif isinstance(segm["counts"], list):
            r = rle_codec.fr_uncompressed(segm)
        else:
            r = dict(segm)
        c = r["counts"]
        if isinstance(c, bytes):
            r = {"size": r["size"], "counts": c.decode("ascii")}
        return r


def _as_list(x) -> List:
    if x is None:
        return []
    return x if isinstance(x, (list, tuple)) else [x]
