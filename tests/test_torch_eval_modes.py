"""The evaluator's throughput modes in the port against the JAX Evaluator
running the same mode, on the same weights and the same batches: the
extent-crop wire (`_inflate`, crop on = off), several images a dispatch
(`images_per_dispatch` 2 and 4 over a bucket of 7 images: chunks of 4 + 2
+ 1), staged uploads, `Lang2Seg.test_forward` over N images against N
single-image calls, and the uid every image gets in every mode.

The batches come from the port's GtBatchLoader over an in-memory mini
REFER split (`data/fixtures.py::mini_refer_split`): portrait and
landscape images, so that the extent crop drops rows or columns. The
JAX Evaluator scores the same numpy batches. Tolerances between the
packages are tests/test_torch_eval_split.py's: the same sentences,
det_correct and seg_correct, and I / U pixel counts within 4 an image
(pixels on the 122/255 cut). The shared RPN class weights are scaled by
100, as there. At this random init the class head saturates: many ROIs
score 1.0 in f32, and where a sentence's two best scores lie within
rounding of each other the two frameworks may pick different boxes. The
split's draw (seed 3) has no sentence whose two best scores are closer
than 1e-6 (about 8 f32 ulps at 1.0), and the fixture checks it."""

import copy
import threading
import time

import numpy as np
import pytest
import torch

import jax

import lang2seg_tpu.engine.evaluator as jax_evaluator
from lang2seg_tpu.engine.evaluator import Evaluator as JaxEvaluator
from lang2seg_tpu.utils.metrics import SegEvalAccumulator as JaxAccumulator
from lang2seg_tpu_torch.data.fixtures import mini_refer_split
from lang2seg_tpu_torch.data.loader import GtBatchLoader
from lang2seg_tpu_torch.engine.evaluator import Evaluator
from lang2seg_tpu_torch.utils.metrics import SegEvalAccumulator
from tests.test_torch_weights import (response_config, shared_weights,
                                      to_port_cfg)

# 7 images of one ref (3 sentences: bucket 4, a bank of 2 rows), then 2 of
# two refs (bucket 8, a bank of 4); originals of 150 x 200 and 200 x 150
# exceed 160 x 160 paste buffers
SIZES = ((100, 120), (120, 100), (150, 200), (100, 120), (200, 150),
         (120, 100), (100, 120), (120, 160), (160, 120))
REFS = (1,) * 7 + (2, 2)
BUCKETS = (4, 8)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = response_config()
    model, jmodel, params = shared_weights(cfg, seed=2, scale_rpn_cls=100.0)
    info, labels, read = mini_refer_split(SIZES, REFS, ("val",) * len(SIZES),
                                          seed=3)
    batches = {}
    for bank in (True, False):
        pcfg = to_port_cfg(cfg)
        pcfg.data.wire_mask_bank = bank
        loader = GtBatchLoader(info, labels, pcfg, seed=3, read_image=read)
        batches[bank] = list(loader.iter_test_batches("val", buckets=BUCKETS))
    for b in batches[True]:
        out = model.test_forward({k: torch.from_numpy(b[k]) for k in
                                  ("images", "im_hw", "labels")})
        scores = torch.where(out["roi_valid"][..., None], out["cls_prob"],
                             -1.0)[:, :, 1:].flatten(1)
        top = torch.topk(scores, 2, dim=1).values
        assert float((top[:, 0] - top[:, 1]).min()) >= 1e-6
    return cfg, model, jmodel, params, batches


def _state(acc):
    return (acc.num_sent, acc.det_correct, acc.cum_i, acc.cum_u,
            tuple(acc.seg_correct), acc.seg_total)


_PORT = {}


def _port(setup, k=1, bank=True, staged=True, **data_kw):
    """The port's accumulator over the split in one mode (each mode is run
    once a module: the runs are deterministic)."""
    key = (k, bank, staged, tuple(sorted(data_kw.items())))
    if key not in _PORT:
        cfg, model = setup[:2]
        pcfg = to_port_cfg(cfg)
        for name, v in data_kw.items():
            setattr(pcfg.data, name, v)
        acc = SegEvalAccumulator()
        Evaluator(model, pcfg, device="cpu").eval_split(
            setup[4][bank], images_per_dispatch=k, stage_uploads=staged,
            acc=acc)
        _PORT[key] = acc
    return _PORT[key]


def _jax(setup, k, monkeypatch, **data_kw):
    """The JAX Evaluator's accumulator over the same batches in a mode."""
    cfg, _, jmodel, params, batches = setup
    cfg = copy.deepcopy(cfg)
    for name, v in data_kw.items():
        setattr(cfg.data, name, v)
    made = []

    class Recorded(JaxAccumulator):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(jax_evaluator, "SegEvalAccumulator", Recorded)
    with jax.default_matmul_precision("float32"):
        JaxEvaluator(jmodel, cfg).eval_split(params, batches[True],
                                             images_per_dispatch=k)
    return made[-1]


def _close(acc, jacc, n_images):
    assert acc.num_sent == jacc.num_sent == acc.seg_total
    assert acc.det_correct == jacc.det_correct
    np.testing.assert_array_equal(acc.seg_correct, jacc.seg_correct)
    assert abs(acc.cum_i - jacc.cum_i) <= 4 * n_images
    assert abs(acc.cum_u - jacc.cum_u) <= 4 * n_images
    assert acc.cum_u > 0


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("granularity", [8, 128])
def test_inflate_recreates_canvas(setup, granularity, packed):
    """_inflate of the crop at each portrait image's bucketed extent gives
    the loader's full uint8 canvas and GT masks (raw or bit-packed) byte
    for byte, as the JAX Evaluator's inflate does (JAX
    test_extent_crop_inflate_recreates_canvas)."""
    cfg, model, jmodel = setup[:3]
    pcfg = to_port_cfg(cfg)
    pcfg.data.wire_extent_granularity = granularity
    jcfg = copy.deepcopy(cfg)
    jcfg.data.wire_extent_granularity = granularity
    ev, jev = Evaluator(model, pcfg, device="cpu"), JaxEvaluator(jmodel, jcfg)
    cropped = 0
    for b in setup[4][True]:
        _, sh, sw, _, _ = ev._extents(b)
        ext = ev._crop_extent(sh, sw)
        assert ext == jev._crop_extent(sh, sw)
        if ext is None:
            continue
        cropped += 1
        hb, wb = ext
        assert hb >= sh and wb >= sw and (hb, wb) != (128, 192)
        masks = b["gt_mask_bank"]
        full_m = np.packbits(masks > 0, axis=-1) if packed else masks
        crop_m = (np.packbits(masks[..., :hb, :wb] > 0, axis=-1) if packed
                  else masks[..., :hb, :wb])
        crop_i = np.ascontiguousarray(b["images"][:, :hb, :wb])
        img, gm = ev._inflate(torch.from_numpy(crop_i),
                              torch.from_numpy(crop_m), full_m.shape[-1])
        np.testing.assert_array_equal(img.numpy(), b["images"])
        np.testing.assert_array_equal(gm.numpy(), full_m)
        jimg, jgm = jev._inflate(crop_i, crop_m, mask_w=full_m.shape[-1])
        np.testing.assert_array_equal(np.asarray(jimg), img.numpy())
        np.testing.assert_array_equal(np.asarray(jgm), gm.numpy())
    assert cropped >= 4


def test_granularity_must_be_a_byte_multiple(setup):
    pcfg = to_port_cfg(setup[0])
    pcfg.data.wire_extent_granularity = 12
    with pytest.raises(ValueError, match="multiple of 8"):
        Evaluator(setup[1], pcfg, device="cpu")
    pcfg.data.wire_extent_crop = False
    Evaluator(setup[1], pcfg, device="cpu")


@pytest.mark.parametrize("bank", [True, False])
@pytest.mark.parametrize("k", [1, 2])
def test_extent_crop_scores_as_the_full_canvas(setup, k, bank):
    """The extent-crop wire (granularity 8 and 128) leaves the
    accumulator state identical to the full-canvas wire, with and without
    the mask bank, one and two images a dispatch (JAX
    test_extent_crop_eval_matches_full_wire)."""
    off = _state(_port(setup, k, bank, wire_extent_crop=False))
    for g in (8, 128):
        assert _state(_port(setup, k, bank, wire_extent_granularity=g)) \
            == off


def test_extent_crop_matches_jax(setup, monkeypatch):
    """The port with the crop on (granularity 8) against the JAX
    Evaluator with the crop on, one image a dispatch."""
    jacc = _jax(setup, 1, monkeypatch, wire_extent_granularity=8)
    _close(_port(setup, 1, wire_extent_granularity=8), jacc,
           len(setup[4][True]))


@pytest.mark.parametrize("k", [2, 4])
def test_chunks_match_jax_and_one_image_a_dispatch(setup, monkeypatch, k):
    """k images a dispatch over the bucket-4 group of 7 (chunks of k, then
    power-of-two remainders: 4 + 2 + 1 at k = 4, 2 + 2 + 2 + 1 at k = 2)
    and the bucket-8 pair: against the JAX Evaluator at the same k (the
    tolerances above) and against the port at one image a dispatch. On
    the CPU that is bit for bit here: the convolutions over k images
    round differently from one image's (within 1e-5 of the map, see
    test_forward_over_images_matches_single_calls), and no count moves on
    this split."""
    n_images = len(setup[4][True])
    acc = _port(setup, k)
    _close(acc, _jax(setup, k, monkeypatch), n_images)
    one = _port(setup, 1)
    _close(acc, one, n_images)
    assert _state(acc) == _state(one)


@pytest.mark.parametrize("k", [2, 4])
def test_staged_uploads_score_as_inline(setup, k):
    """stage_uploads True and False give the same state (JAX
    test_staged_uploads_match_inline_dispatch)."""
    assert _state(_port(setup, k, staged=True)) == \
        _state(_port(setup, k, staged=False))


def test_chunks_split_as_the_jax_evaluator(setup):
    """The dispatches of k = 4: the 7 bucket-4 images in chunks of 4, 2
    and 1, the bucket-8 pair together; each image in arrival order."""
    cfg, model = setup[:2]
    ev = Evaluator(model, to_port_cfg(cfg), device="cpu")
    sizes, real = [], ev._stack_chunk

    def recorded(chunk, uids):
        sizes.append((chunk[0]["labels"].shape[0],
                      [b["image_id"] for b in chunk]))
        return real(chunk, uids)

    ev._stack_chunk = recorded
    ev.eval_split(setup[4][True], images_per_dispatch=4)
    ids = [b["image_id"] for b in setup[4][True]]
    four = [i for b, i in zip(setup[4][True], ids)
            if b["labels"].shape[0] == 4]
    assert sorted(len(c) for s, c in sizes if s == 4) == [1, 2, 4]
    assert [i for s, c in sizes if s == 4 for i in c] == four
    assert [len(c) for s, c in sizes if s == 8] == [2]


def _uids(ev, batches, k, delay=0.0):
    """{image_id: uid} of one eval_split; the staging worker sleeps
    `delay` s before stacking each chunk."""
    got, stack, dispatch = {}, ev._stack_chunk, ev.dispatch_image

    def stacked(chunk, uids):
        if threading.current_thread() is not threading.main_thread():
            time.sleep(delay)
        got.update(zip((b["image_id"] for b in chunk), uids))
        return stack(chunk, uids)

    def dispatched(batch, sent_valid=None):
        uid = ev._rng_uid + 1
        got.setdefault(batch["image_id"], uid)
        return dispatch(batch, sent_valid)

    ev._stack_chunk, ev.dispatch_image = stacked, dispatched
    ev.eval_split(batches, images_per_dispatch=k)
    return got


def test_every_mode_gives_an_image_its_uid(setup):
    """With 160 x 160 paste buffers the 150 x 200 and 200 x 150 images go
    to the host one at a time while the others wait in chunks: every
    image still gets the uid that one image a dispatch gives it, on every
    run, with the staging worker delayed by 0 to 40 ms."""
    cfg, model = setup[:2]
    pcfg = to_port_cfg(cfg)
    pcfg.data.max_orig_h = pcfg.data.max_orig_w = 160
    batches = setup[4][True]
    want = _uids(Evaluator(model, pcfg, device="cpu"), batches, 1)
    assert sorted(want.values()) == list(range(1, len(batches) + 1))
    ev = Evaluator(model, pcfg, device="cpu")
    assert sum(not ev._fits(*ev._extents(b)[3:]) for b in batches) == 2
    for run in range(5):
        assert _uids(Evaluator(model, pcfg, device="cpu"), batches, 4,
                     delay=0.01 * run) == want


def _images(cfg, n, seed):
    rng = np.random.RandomState(seed)
    d = cfg.data
    return {"images": rng.randint(0, 256, (n, d.canvas_h, d.canvas_w, 3)
                                  ).astype(np.uint8),
            "im_hw": np.stack([rng.uniform(0.6, 1.0, n) * d.canvas_h,
                               rng.uniform(0.6, 1.0, n) * d.canvas_w],
                              1).astype(np.float32)}


@pytest.mark.parametrize("mode", ["nms", "top"])
def test_forward_over_images_matches_single_calls(setup, mode):
    """test_forward over 3 images of 4 expressions against 3 one-image
    calls: roi_valid equal; rois within 1e-3 of their largest magnitude
    and cls_prob within 1e-4. The tolerance is f32 rounding: the
    backbone's convolutions over 3 images sum in another order than over
    one (within 1e-5 of the C4 map's magnitude, checked here), and the
    RPN's exp box decode and the tail amplify it. In mode 'top' (a 64 x
    64 canvas: 192 anchors for rpn_top_n 256) each image draws its random
    pad from its own generator, so the pad rows are the single calls'
    draws."""
    cfg, model = setup[:2]
    pcfg = to_port_cfg(cfg)
    if mode == "top":
        pcfg.test.mode, pcfg.test.rpn_top_n = "top", 256
        pcfg.data.canvas_h = pcfg.data.canvas_w = 64
    old, model.cfg = model.cfg, pcfg
    try:
        b = _images(pcfg, 3, seed=11)
        labels = np.random.RandomState(12).randint(
            1, pcfg.model.vocab_size, (12, pcfg.data.max_len)).astype(
                np.int64)
        gens = lambda: [torch.Generator().manual_seed(40 + i)  # noqa: E731
                        for i in range(3)]
        batched = model.test_forward(
            {"images": torch.from_numpy(b["images"]),
             "im_hw": torch.from_numpy(b["im_hw"]),
             "labels": torch.from_numpy(labels)}, gens())
        singles = [model.test_forward(
            {"images": torch.from_numpy(b["images"][i:i + 1]),
             "im_hw": torch.from_numpy(b["im_hw"][i:i + 1]),
             "labels": torch.from_numpy(labels[4 * i:4 * i + 4])}, g)
            for i, g in enumerate(gens())]
        x = model._images(torch.from_numpy(b["images"]))
        with torch.no_grad():
            maps = model.backbone.head(x)
            one = torch.cat([model.backbone.head(x[i:i + 1])
                             for i in range(3)])
    finally:
        model.cfg = old
    assert float((maps - one).abs().max()) <= 1e-5 * float(one.abs().max())
    for key, tol in (("rois", 1e-3), ("cls_prob", 1e-4)):
        want = torch.cat([s[key] for s in singles])
        assert batched[key].shape == want.shape
        np.testing.assert_allclose(
            batched[key].numpy(), want.numpy(), rtol=0,
            atol=tol * float(want.abs().max()), err_msg=key)
    assert torch.equal(batched["roi_valid"],
                       torch.cat([s["roi_valid"] for s in singles]))
    assert batched["gated_conv"].shape[0] == 12
    if mode == "top":
        assert bool(batched["roi_valid"].all())
