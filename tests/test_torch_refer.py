"""The port's REFER API (lang2seg_tpu_torch.data.refer) and prepro
(data/prepro.py, cli/prepro.py) against the JAX package's, on two raw
trees: one written by the JAX package's `make_mini_refer` (polygon boxes,
JPEG images) and one by the port's `write_mini_refer` (star polygons of
one or two parts, an uncompressed-RLE annotation with a ref on it, a
crowd annotation, a degenerate box, a Python 2 protocol pickle). Every
query, mask and RLE, the data.json dict and the label array must be
identical."""

import json
import os

import numpy as np
import pytest

from lang2seg_tpu.data import rle as jrle
from lang2seg_tpu.data.fixtures import make_mini_refer
from lang2seg_tpu.data.prepro import build_att_vocab as jbuild_att_vocab
from lang2seg_tpu.data.prepro import build_vocab as jbuild_vocab
from lang2seg_tpu.data.prepro import run_prepro as jrun_prepro
from lang2seg_tpu.data.refer import REFER as JREFER
from lang2seg_tpu_torch.cli import prepro as cli_prepro
from lang2seg_tpu_torch.data.fixtures import write_mini_refer
from lang2seg_tpu_torch.data.loader import GtBatchLoader
from lang2seg_tpu_torch.data.prepro import (DEFAULT_MAX_LENGTH, build_att_vocab,
                                            build_vocab, prepro_data,
                                            run_prepro)
from lang2seg_tpu_torch.data.refer import REFER

# (image (h, w), refs, split) of the port's tree: every split kind the
# REFER API filters by, and two images without refs
IMAGE_HW = ((60, 80), (80, 60), (64, 64), (60, 80), (80, 60), (72, 96))
REFS = (2, 3, 2, 2, 1, 2)
SPLITS = ("train", "train", "val", "testA", "testB", "train")
EXTRA_HW = ((50, 70), (70, 50))


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_rle():
    """The JAX codec's NumPy path, whether or not its native library is
    built (the port has no native library)."""
    saved, jrle._lib = jrle._lib, None
    yield
    jrle._lib = saved


@pytest.fixture(scope="module", params=["jax_tree", "port_tree"])
def tree(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(request.param))
    if request.param == "jax_tree":
        make_mini_refer(root, num_images=6, refs_per_image=3, sents_per_ref=3)
    else:
        write_mini_refer(root, IMAGE_HW, REFS, SPLITS, EXTRA_HW,
                         sents_per_ref=3, seed=1)
    return request.param, root


def test_port_tree_has_every_annotation_kind(tmp_path):
    write_mini_refer(str(tmp_path), IMAGE_HW, REFS, SPLITS, EXTRA_HW, seed=1)
    with open(tmp_path / "refcoco" / "instances.json") as f:
        inst = json.load(f)
    with open(tmp_path / "coco" / "instances_train2014.json") as f:
        coco = json.load(f)
    anns = inst["annotations"]
    assert any(isinstance(a["segmentation"], dict) and not a["iscrowd"]
               for a in anns)
    assert any(a["iscrowd"] for a in anns)
    assert any(a["bbox"][2] < 1 for a in anns)
    assert any(isinstance(a["segmentation"], list)
               and len(a["segmentation"]) == 2 for a in anns)
    per_image = {}
    for a in coco["annotations"]:
        if not a["iscrowd"] and a["bbox"][2] >= 1:
            per_image[a["image_id"]] = per_image.get(a["image_id"], 0) + 1
    assert len(coco["images"]) == len(IMAGE_HW) + len(EXTRA_HW)
    assert len(inst["images"]) == len(IMAGE_HW)
    assert max(per_image.values()) <= 8 and min(per_image.values()) >= 2


def test_refer_indices_and_queries_match_jax(tree):
    _, root = tree
    port, jax_ = REFER(root), JREFER(root)
    assert port.image_dir == jax_.image_dir
    for name in ("Anns", "Imgs", "Cats", "Refs", "imgToAnns", "imgToRefs",
                 "annToRef", "catToRefs", "Sents", "sentToRef",
                 "sentToTokens"):
        assert getattr(port, name) == getattr(jax_, name), name
    for split in ("", "train", "val", "test", "testA", "testB", "testC",
                  "testAB"):
        assert port.getRefIds(split=split) == jax_.getRefIds(split=split)
    img = sorted(port.Imgs)[1]
    cat = sorted(port.Cats)[0]
    assert port.getRefIds(image_ids=img) == jax_.getRefIds(image_ids=img)
    assert port.getRefIds(cat_ids=[cat]) == jax_.getRefIds(cat_ids=[cat])
    assert port.getAnnIds(image_ids=[img], cat_ids=cat) == \
        jax_.getAnnIds(image_ids=[img], cat_ids=cat)
    rids = port.getRefIds(split="train")[:3]
    assert port.getAnnIds(ref_ids=rids) == jax_.getAnnIds(ref_ids=rids)
    assert sorted(port.getImgIds(ref_ids=rids)) == \
        sorted(jax_.getImgIds(ref_ids=rids))
    assert port.getImgIds() == jax_.getImgIds()
    assert port.getCatIds() == jax_.getCatIds()
    assert port.loadRefs(rids) == jax_.loadRefs(rids)
    assert port.loadAnns(port.getAnnIds()[:2]) == \
        jax_.loadAnns(jax_.getAnnIds()[:2])
    assert port.loadImgs(img) == jax_.loadImgs(img)
    with pytest.raises(ValueError):
        port.getRefIds(split="nosuch")


def test_refer_masks_and_rles_match_jax(tree):
    """getMask and getRefRLE of every ref: bit-identical, and the RLE
    decodes to the mask."""
    kind, root = tree
    port, jax_ = REFER(root), JREFER(root)
    uncompressed = 0
    for ref in port.refs_data:
        got, want = port.getMask(ref), jax_.getMask(ref)
        np.testing.assert_array_equal(got["mask"], want["mask"])
        assert got["mask"].dtype == np.uint8 and got["area"] == want["area"]
        r = port.getRefRLE(ref)
        assert r == jax_.getRefRLE(ref)
        assert isinstance(r["counts"], str)
        np.testing.assert_array_equal(
            np.asarray(jrle.decode(r)), got["mask"])
        uncompressed += isinstance(
            port.Anns[ref["ann_id"]]["segmentation"], dict)
    assert uncompressed == (kind == "port_tree")


@pytest.mark.parametrize("threshold", [0, 1, 5])
def test_build_vocab_matches_jax(tree, threshold):
    _, root = tree
    port, jax_ = REFER(root), JREFER(root)
    assert build_vocab(port, threshold) == jbuild_vocab(jax_, threshold)


def test_prepro_data_matches_jax_files(tree, tmp_path):
    """The port's data.json / data.h5 against the JAX prepro's (both
    written, then read back), and prepro_data's in-memory output against
    both."""
    import h5py

    _, root = tree
    jp, jh = jrun_prepro(root, "refcoco", "unc", str(tmp_path / "jax"),
                         count_threshold=1)
    pp, ph = run_prepro(root, "refcoco", "unc", str(tmp_path / "port"),
                        count_threshold=1)
    with open(jp) as f:
        want = json.load(f)
    with open(pp) as f:
        got = json.load(f)
    assert got == want
    with h5py.File(jh, "r") as f:
        want_labels = f["labels"][...]
    with h5py.File(ph, "r") as f:
        got_labels = f["labels"][...]
    assert got_labels.dtype == want_labels.dtype == np.int32
    np.testing.assert_array_equal(got_labels, want_labels)
    mem, labels = prepro_data(REFER(root), DEFAULT_MAX_LENGTH["refcoco"],
                              count_threshold=1)
    assert json.loads(json.dumps(mem)) == want
    np.testing.assert_array_equal(labels, want_labels)


def test_prepro_attribute_vocab(tree, tmp_path):
    """build_att_vocab: the top-k attribute words by count, each ref's
    kept words, written into the refs by prepro_data."""
    _, root = tree
    refer = REFER(root)
    rids = [r["ref_id"] for r in refer.refs_data]
    # counts: red on every ref > left on two in three > big on one in three
    atts = {str(rid): ["red"] + ["left"] * (i % 3 != 2) + ["big"] * (i % 3 == 0)
            for i, rid in enumerate(rids)}
    path = tmp_path / "atts.json"
    path.write_text(json.dumps(atts))
    att_to_ix, kept = build_att_vocab(str(path), top_k=2)
    assert (att_to_ix, kept) == jbuild_att_vocab(str(path), top_k=2)
    assert att_to_ix == {"red": 0, "left": 1}
    assert all(set(w) <= {"red", "left"} for w in kept.values())
    out, _ = prepro_data(refer, 10, count_threshold=0, att_json=str(path),
                         att_top_k=2)
    assert out["att_to_ix"] == att_to_ix
    assert all(r["att_wds"] == kept[r["ref_id"]] for r in out["refs"])


def test_cli_prepro_writes_what_the_loader_reads(tmp_path):
    """`python -m lang2seg_tpu_torch.cli.prepro` on the port's tree; the
    port's GtBatchLoader reads its files and draws a batch."""
    root = str(tmp_path)
    _, read = write_mini_refer(root, IMAGE_HW, REFS, SPLITS, seed=2)
    out = str(tmp_path / "prepro")
    jp, hp = cli_prepro.main(["--data-root", root, "--output-dir", out,
                              "--word-count-threshold", "0"])
    assert (jp, hp) == (os.path.join(out, "data.json"),
                        os.path.join(out, "data.h5"))
    from tests.test_network import tiny_config
    from tests.test_torch_weights import to_port_cfg
    cfg = to_port_cfg(tiny_config())
    loader = GtBatchLoader(jp, hp, cfg, seed=0, read_image=read)
    assert loader.max_length == 10
    batch = loader.get_batch("train", num_images=2, num_expr=4)
    assert batch["labels"].shape == (4, 10)
    assert batch["gt_masks"].any()
