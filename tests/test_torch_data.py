"""The port's data path against the JAX package's: the RLE codec, the
canvas resize against cv2, the REFER loaders' train and test batches
(bucketed, with the ref-deduped mask bank), the cycle and caption
loaders, the prefetcher, the timer and the learnable synthetic set.

The mini REFER split is the JAX package's `make_mini_refer` + `run_prepro`
(the port has no prepro yet); both packages' loaders read the same
data.json / data.h5 with the same seed and must draw the same batches.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import cv2

from lang2seg_tpu.data import rle as jrle
from lang2seg_tpu.data.caption_loader import \
    CaptionBatchLoader as JCaptionBatchLoader
from lang2seg_tpu.data.fixtures import make_mini_refer
from lang2seg_tpu.data.loader import CycleBatchLoader as JCycleBatchLoader
from lang2seg_tpu.data.loader import GtBatchLoader as JGtBatchLoader
from lang2seg_tpu.data.prepro import run_prepro
from lang2seg_tpu.data.synthetic import \
    synthetic_learnable_set as jsynthetic_learnable_set
from lang2seg_tpu_torch.data import rle
from lang2seg_tpu_torch.data.caption_loader import CaptionBatchLoader
from lang2seg_tpu_torch.data.loader import (CycleBatchLoader, GtBatchLoader,
                                            resize_linear, xywh_to_xyxy)
from lang2seg_tpu_torch.data.prefetch import Prefetcher
from lang2seg_tpu_torch.data.synthetic import synthetic_learnable_set
from lang2seg_tpu_torch.utils.timer import Timer
from tests.test_network import tiny_config
from tests.test_torch_weights import to_port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the canvas resize against cv2.resize (INTER_LINEAR, f32): values within
# RESIZE_ATOL, and after rounding to uint8 at most RESIZE_U8_FRAC of the
# pixels one level apart (none more)
RESIZE_ATOL = 1e-3
RESIZE_U8_FRAC = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def refer(tmp_path_factory):
    """A mini REFER split with 3 refs of 3 sentences an image: 9 test
    sentences an image, so the buckets (4, 8, 16) pad them to 16 with a
    bank of 8 rows."""
    root = str(tmp_path_factory.mktemp("torch_refer"))
    make_mini_refer(root, num_images=6, refs_per_image=3, sents_per_ref=3)
    jp, hp = run_prepro(root, "refcoco", "unc", os.path.join(root, "prepro"),
                        count_threshold=0)
    return root, jp, hp


def make_cfg(root, canvas=(128, 192), **data_kw):
    cfg = tiny_config()
    cfg.data.canvas_h, cfg.data.canvas_w = canvas
    cfg.data.image_dir = os.path.join(root, "images", "train2014")
    cfg.train.expressions_per_batch = 5
    cfg.train.images_per_batch = 2
    for k, v in data_kw.items():
        setattr(cfg.data, k, v)
    return cfg


def loaders(refer, cls=GtBatchLoader, jcls=JGtBatchLoader, seed=3, **kw):
    root, jp, hp = refer
    cfg = make_cfg(root, **kw)
    return jcls(jp, hp, cfg, seed=seed), cls(jp, hp, to_port_cfg(cfg),
                                             seed=seed)


def assert_canvas_close(got, want):
    """Canvases from the port's resize against cv2's."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= RESIZE_U8_FRAC
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def assert_batches_equal(got, want, canvases=("images",)):
    assert set(got) == set(want)
    for k in want:
        if k in canvases:
            assert_canvas_close(np.asarray(got[k]), np.asarray(want[k]))
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------- RLE


def _masks(seed):
    r = np.random.RandomState(seed)
    out = [np.zeros((7, 5), np.uint8), np.ones((6, 9), np.uint8),
           (r.uniform(size=(31, 17)) > 0.5).astype(np.uint8)]
    m = np.zeros((120, 160), np.uint8)
    m[10:70, 30:95] = 1
    m[80:, :12] = 1
    out.append(m)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_encode_decode_bit_identical(seed):
    """encode gives the JAX codec's compressed bytes; decode of them, of
    a str and of uncompressed counts, the JAX codec's masks; both invert
    each other."""
    for m in _masks(seed):
        got = rle.encode(m)
        want = jrle.encode(m)
        assert got == want
        for obj in (got, dict(got, counts=got["counts"].decode("ascii")),
                    {"size": got["size"],
                     "counts": list(rle.str_decode(got["counts"]))}):
            d = rle.decode(obj)
            np.testing.assert_array_equal(d, jrle.decode(obj))
            np.testing.assert_array_equal(d, m)
        counts = rle.str_decode(got["counts"])
        np.testing.assert_array_equal(counts, jrle.str_decode(got["counts"]))
        assert rle.str_encode(counts) == got["counts"]
    stack = [rle.encode(m) for m in _masks(seed)[2:3] * 2]
    np.testing.assert_array_equal(rle.decode(stack), jrle.decode(stack))


@pytest.mark.parametrize("res", [(120, 160), (128, 171), (37, 53),
                                 (300, 400)])
def test_rle_decode_resize_batch_bit_identical(res):
    """The loader's per-ref mask prep: nearest resize onto the canvas."""
    masks = [m for m in _masks(3) if m.shape == (120, 160)] + [
        (np.random.RandomState(5).uniform(size=(120, 160)) > 0.7)
        .astype(np.uint8)]
    rles = [jrle.encode(m) for m in masks]
    out_h, out_w = max(res[0], 128), max(res[1], 192)
    got = rle.decode_resize_batch(rles, out_h, out_w, *res)
    want = jrle.decode_resize_batch(rles, out_h, out_w, *res)
    np.testing.assert_array_equal(got, want)
    assert rle.decode_resize_batch([], 4, 8, 2, 2).shape == (0, 4, 8)


# ---------------------------------------------------------------- resize


# (h, w, scale): COCO's 427x640 and 640x427 at the reference rule (short
# side 600) and at the flagship canvas cap (640 / 427), 480x640 at the
# rule, the mini fixture's 120x160 at the tiny canvas caps, a downscale
@pytest.mark.parametrize("h,w,scale", [
    (427, 640, 600 / 427), (640, 427, 600 / 427), (427, 640, 640 / 427),
    (640, 427, 1024 / 640 * 0.999), (480, 640, 600 / 480),
    (120, 160, 128 / 120), (120, 160, 256 / 120), (300, 500, 0.37)])
def test_resize_matches_cv2(h, w, scale):
    rng = np.random.RandomState(h + w)
    im = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    got = resize_linear(im, scale)
    want = cv2.resize(im.astype(np.float32), None, fx=scale, fy=scale,
                      interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.float32
    assert_canvas_close(got, want)
    assert_canvas_close(np.clip(np.round(got), 0, 255).astype(np.uint8),
                        np.clip(np.round(want), 0, 255).astype(np.uint8))


# ---------------------------------------------------------------- loaders


@pytest.mark.parametrize("wire", [
    {}, {"wire_uint8_images": False, "wire_packed_masks": False},
    {"canvas": (256, 384)}], ids=["uint8_packed", "f32_raw", "canvas256"])
def test_train_batches_match_jax(refer, wire):
    """get_batch across an epoch's wrap (4 train images, 2 a batch) and
    a state_dict round trip: the same images, expressions, labels, boxes
    and masks as the JAX loader; canvases to the resize tolerance."""
    jl, pl = loaders(refer, **wire)
    wrapped = []
    for _ in range(4):
        want, got = jl.get_batch("train"), pl.get_batch("train")
        assert_batches_equal(got, want)
        wrapped.append(bool(got["wrapped"]))
    assert any(wrapped)
    state = pl.state_dict()
    jstate = jl.state_dict()
    first = pl.get_batch("train")
    pl.load_state_dict(state)
    again = pl.get_batch("train")
    assert_batches_equal(again, first, canvases=())
    jl.load_state_dict(jstate)
    assert_batches_equal(again, jl.get_batch("train"))


def test_loader_state_dict_matches_jax(refer):
    """The iterator state is interchangeable with the JAX loader's."""
    jl, pl = loaders(refer, seed=7)
    for _ in range(3):
        jl.get_batch("train")
    pl.load_state_dict(jl.state_dict())
    assert_batches_equal(pl.get_batch("train"), jl.get_batch("train"))
    assert pl.state_dict()["iterators"] == jl.state_dict()["iterators"]


@pytest.mark.parametrize("bank", [True, False])
def test_test_batches_match_jax(refer, bank):
    """get_test_batch with buckets, and iter_test_batches over every
    split: sentences, boxes, validity, the mask bank and its index (or the
    per-sentence masks) exactly; 9 sentences pad to the 16 bucket."""
    jl, pl = loaders(refer, wire_mask_bank=bank)
    for split in ("val", "testA", "train"):
        got = list(pl.iter_test_batches(split, buckets=(4, 8, 16)))
        want = list(jl.iter_test_batches(split, buckets=(4, 8, 16)))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert_batches_equal(g, w)
            assert g["labels"].shape[0] == 16
            assert int(g["sent_valid"].sum()) == 9
            if bank:
                assert g["gt_mask_bank"].shape[0] == 8
    got = pl.get_test_batch("val", max_sents=12)
    want = jl.get_test_batch("val", max_sents=12)
    assert_batches_equal(got, want)


def test_cycle_and_caption_loaders_match_jax(refer):
    jl, pl = loaders(refer, JCycleBatchLoader, CycleBatchLoader)
    for _ in range(2):
        got, want = pl.get_batch("train"), jl.get_batch("train")
        assert "cap_labels" in got
        assert_batches_equal(got, want)
    jl, pl = loaders(refer, JCaptionBatchLoader, CaptionBatchLoader)
    got, want = pl.get_caption_batch("train", 6), \
        jl.get_caption_batch("train", 6)
    assert got["cap_labels"].shape == (6, pl.max_length + 2)
    assert_batches_equal(got, want)


def test_loader_from_memory(refer):
    """data.json as a dict, data.h5 as the label array and a read_image
    callable give the file-backed loader's batches."""
    import json
    import h5py
    root, jp, hp = refer
    cfg = to_port_cfg(make_cfg(root))
    with open(jp) as f:
        info = json.load(f)
    with h5py.File(hp, "r") as f:
        labels = f["labels"][...]
    cache = {}

    def read(path):
        cache[path] = cv2.imread(path)
        return cache[path]

    a = GtBatchLoader(jp, hp, cfg, seed=5)
    b = GtBatchLoader(info, labels, cfg, seed=5, read_image=read)
    for _ in range(3):
        assert_batches_equal(b.get_batch("train"), a.get_batch("train"),
                             canvases=())
    assert_batches_equal(b.get_test_batch("val", buckets=(4, 16)),
                         a.get_test_batch("val", buckets=(4, 16)),
                         canvases=())
    assert cache and all(os.path.dirname(p) == cfg.data.image_dir
                         for p in cache)
    with pytest.raises(FileNotFoundError):
        GtBatchLoader(info, labels, cfg, read_image=lambda p: None
                      ).get_batch("train")
    with pytest.raises(NotImplementedError, match="Queue 1 #5"):
        a.get_batch("train", num_shards=2)


def test_xywh_to_xyxy():
    np.testing.assert_array_equal(
        xywh_to_xyxy(np.array([[10.0, 20.0, 5.0, 8.0]])), [[10, 20, 14, 27]])


def test_data_modules_import_without_h5py_cv2_pil():
    """The loader and chip_smoke's imports need neither h5py, cv2 nor
    PIL (the card machine has none of them)."""
    code = ("import sys\n"
            "for m in ('h5py', 'cv2', 'PIL'): sys.modules[m] = None\n"
            "import lang2seg_tpu_torch.data.loader\n"
            "import lang2seg_tpu_torch.data.caption_loader\n"
            "import lang2seg_tpu_torch.engine.trainer\n"
            "import lang2seg_tpu_torch.cli.train, lang2seg_tpu_torch.cli.eval\n"
            "import lang2seg_tpu_torch.tools.learn_synthetic\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


# ------------------------------------------------------- prefetch, timer


def test_prefetcher_yields_in_order_and_joins():
    count = iter(range(1000))
    pf = Prefetcher(lambda: next(count), depth=2)
    assert [pf.get() for _ in range(5)] == [0, 1, 2, 3, 4]
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_surfaces_exceptions():
    def boom():
        raise ValueError("loader failed")
    pf = Prefetcher(boom)
    with pytest.raises(ValueError, match="loader failed"):
        pf.get()
    pf.close()
    assert not pf._thread.is_alive()
    assert threading.active_count() >= 1


def test_timer():
    t = Timer()
    dts = []
    for _ in range(2):
        t.tic("a")
        dts.append(t.toc("a"))
    assert min(dts) >= 0
    assert t.average_time("a") == pytest.approx(sum(dts) / 2)
    assert t.average_time("none") == 0


# ---------------------------------------------------------------- synthetic


@pytest.mark.parametrize("seed,n", [(0, 4), (3, 2)])
def test_synthetic_learnable_set_matches_jax(seed, n):
    cfg = tiny_config()
    got_train, got_eval = synthetic_learnable_set(to_port_cfg(cfg), n, seed)
    want_train, want_eval = jsynthetic_learnable_set(cfg, n, seed)
    assert_batches_equal(got_train, want_train, canvases=())
    assert len(got_eval) == len(want_eval) == n
    for g, w in zip(got_eval, want_eval):
        assert_batches_equal(g, w, canvases=())
