"""The port's `Evaluator.eval_split` against the JAX package's over a mini
REFER split (bucketed test batches with the ref-deduped mask bank), on
the same weights: the device paste-back, the host paste-back, the
reference-exact mode, images beyond the paste buffers and test mode
'top''s per-image draws; and the train and eval command lines end to end
on the CPU.

The shared RPN class weights are scaled by 100 in both packages, as in
tests/test_torch_slice.py, so that near-tied objectness scores at the
random init do not reorder between the frameworks."""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from lang2seg_tpu.data.fixtures import make_mini_refer
from lang2seg_tpu.data.loader import GtBatchLoader as JGtBatchLoader
from lang2seg_tpu.data.prepro import run_prepro as jrun_prepro
from lang2seg_tpu.engine.evaluator import Evaluator as JaxEvaluator
from lang2seg_tpu.utils.metrics import SegEvalAccumulator as JaxAccumulator
from lang2seg_tpu_torch.cli import eval as cli_eval
from lang2seg_tpu_torch.cli import train as cli_train
from lang2seg_tpu_torch.data.loader import GtBatchLoader
from lang2seg_tpu_torch.data.prepro import run_prepro
from lang2seg_tpu_torch.engine.evaluator import Evaluator
from lang2seg_tpu_torch.utils.metrics import SegEvalAccumulator
from tests.test_torch_weights import (response_config, shared_weights,
                                      to_port_cfg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = ("train", "val", "testA")
BUCKETS = (4, 8)              # 4 sentences an image: one bucket, a bank of 2


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_eval_data"))
    make_mini_refer(root)
    # each package's loader reads its own prepro's files (the CLIs read
    # the port's, from <root>/prepro)
    port_files = run_prepro(root, "refcoco", "unc",
                            os.path.join(root, "prepro"), count_threshold=0)
    jax_files = jrun_prepro(root, "refcoco", "unc",
                            os.path.join(root, "prepro_jax"),
                            count_threshold=0)
    cfg = response_config()
    cfg.data.image_dir = os.path.join(root, "images", "train2014")
    cfg.model.vocab_size = 64
    model, jmodel, params = shared_weights(cfg, seed=2, scale_rpn_cls=100.0)
    return root, port_files, jax_files, cfg, model, jmodel, params


_PORT_EVALS = {}


def _port_eval(setup, pipeline_depth=4, ev_kw=None, **data_kw):
    """The port's accumulator over SPLITS; each setting is run once a
    module (the runs are deterministic)."""
    key = (pipeline_depth, tuple(sorted((ev_kw or {}).items())),
           tuple(sorted(data_kw.items())))
    if key not in _PORT_EVALS:
        _PORT_EVALS[key] = _run_port_eval(setup, pipeline_depth, ev_kw,
                                          **data_kw)
    return _PORT_EVALS[key]


def _run_port_eval(setup, pipeline_depth=4, ev_kw=None, **data_kw):
    _, port_files, jax_files, cfg, model, _, _ = setup
    pcfg = to_port_cfg(cfg)
    for k, v in data_kw.items():
        setattr(pcfg.data, k, v)
    loader = GtBatchLoader(*port_files, pcfg, seed=3)
    acc = SegEvalAccumulator()
    ev = Evaluator(model, pcfg, device="cpu", **(ev_kw or {}))
    for split in SPLITS:
        ev.eval_split(loader.iter_test_batches(split, buckets=BUCKETS),
                      pipeline_depth=pipeline_depth, acc=acc)
    return acc


def _state(acc):
    return (acc.num_sent, acc.det_correct, acc.cum_i, acc.cum_u,
            tuple(acc.seg_correct), acc.seg_total)


def test_eval_split_matches_jax(setup):
    """Every image of three splits through both evaluators: the same
    sentences, det_correct and seg_correct, and I / U pixel counts within
    4 an image (pixels on the 122/255 cut)."""
    _, port_files, jax_files, cfg, _, jmodel, params = setup
    acc = _port_eval(setup)
    jl = JGtBatchLoader(*jax_files, cfg, seed=3)
    jev = JaxEvaluator(jmodel, cfg)
    jacc = JaxAccumulator()
    n_images = 0
    with jax.default_matmul_precision("float32"):
        for split in SPLITS:
            batches = list(jl.iter_test_batches(split, buckets=BUCKETS))
            assert all("gt_mask_bank" in b for b in batches)
            for b in batches:
                jev.eval_image(params, b, jacc, sent_valid=b["sent_valid"])
            n_images += len(batches)
            split_acc = JaxAccumulator()
            for b in batches:
                jev.eval_image(params, b, split_acc,
                               sent_valid=b["sent_valid"])
            assert jev.eval_split(params, batches) == split_acc.summary()
    assert n_images == 6
    assert acc.num_sent == jacc.num_sent == 24
    assert acc.det_correct == jacc.det_correct
    np.testing.assert_array_equal(acc.seg_correct, jacc.seg_correct)
    assert abs(acc.cum_i - jacc.cum_i) <= 4 * n_images
    assert abs(acc.cum_u - jacc.cum_u) <= 4 * n_images
    assert acc.cum_u > 0


def test_eval_split_mask_bank_and_pipeline(setup):
    """The bank expanded on the device scores exactly as per-sentence
    masks; draining each image at once scores as a 4-deep pipeline."""
    base = _state(_port_eval(setup))
    assert _state(_port_eval(setup, wire_mask_bank=False)) == base
    assert _state(_port_eval(setup, pipeline_depth=1)) == base


def test_eval_split_restores_mode_and_chunks_match(setup):
    """eval_split leaves a model in train mode as it found it, and two
    images a dispatch over the same val batches score as one."""
    _, port_files, jax_files, cfg, model, _, _ = setup
    pcfg = to_port_cfg(cfg)
    ev = Evaluator(model, pcfg, device="cpu")
    model.train()
    loader = GtBatchLoader(*port_files, pcfg, seed=3)
    batches = list(loader.iter_test_batches("val", buckets=BUCKETS))
    s = ev.eval_split(batches)
    assert model.training
    model.eval()
    assert all(0.0 <= v <= 1.0 for v in s.values())
    assert ev.eval_split(batches, images_per_dispatch=2) == s


def _jax_eval(setup, ev_kw, **data_kw):
    """The JAX Evaluator over the same splits, image by image; returns its
    accumulator and the records its dispatch made (host paths keep the
    mask probabilities there)."""
    _, port_files, jax_files, cfg, _, jmodel, params = setup
    cfg = copy.deepcopy(cfg)
    for k, v in data_kw.items():
        setattr(cfg.data, k, v)
    jl = JGtBatchLoader(*jax_files, cfg, seed=3)
    jev = JaxEvaluator(jmodel, cfg, **ev_kw)
    jacc, recs = JaxAccumulator(), []
    with jax.default_matmul_precision("float32"):
        for split in SPLITS:
            for b in jl.iter_test_batches(split, buckets=BUCKETS):
                rec = jev.dispatch_image(params, b, b["sent_valid"])
                jev.drain(rec, jacc)
                recs.append(rec)
    return jacc, recs


HOST_MODES = {"host_paste": ({"device_paste": False}, {}),
              "reference_exact": ({"reference_exact": True},
                                  {"reference_exact_masks": True})}


@pytest.mark.parametrize("mode", sorted(HOST_MODES))
def test_eval_split_host_modes_match_jax(setup, mode):
    """The host paste-back (recover_masks + nearest_resize, 122/255) and
    the reference-exact chain (bytescale + Pillow-bilinear paste, > 122,
    Pillow-NEAREST GT in the loader and the evaluator) over every image
    of three splits, against the JAX Evaluator(device_paste=False) and
    Evaluator(reference_exact=True): the same sentences, det_correct and
    seg_correct, I / U within 4 pixels an image (the mask probabilities
    differ by f32 rounding between the frameworks). Given the JAX
    records' own boxes and probabilities, the port's drain accumulates
    the same numbers bit for bit."""
    ev_kw, data_kw = HOST_MODES[mode]
    acc = _port_eval(setup, ev_kw=ev_kw, **data_kw)
    jacc, recs = _jax_eval(setup, ev_kw, **data_kw)
    assert acc.num_sent == jacc.num_sent == acc.seg_total == 24
    assert acc.det_correct == jacc.det_correct
    np.testing.assert_array_equal(acc.seg_correct, jacc.seg_correct)
    assert abs(acc.cum_i - jacc.cum_i) <= 4 * len(recs)
    assert abs(acc.cum_u - jacc.cum_u) <= 4 * len(recs)
    assert acc.cum_u > 0
    pcfg = to_port_cfg(setup[3])
    for k, v in data_kw.items():
        setattr(pcfg.data, k, v)
    ev = Evaluator(setup[4], pcfg, device="cpu", **ev_kw)
    assert not ev.device_paste
    same = SegEvalAccumulator()
    for rec in recs:
        assert "dev_probs" in rec
        ev.drain(dict(rec, sel=torch.from_numpy(np.array(rec["sel"])),
                      probs=torch.from_numpy(np.array(rec["dev_probs"]))),
                 same)
    assert _state(same) == _state(jacc)


def test_host_paste_agrees_with_device_paste(setup):
    """The host and the device paste-backs of the port on the same split:
    det acc identical, seg_correct identical, I / U within 4 pixels an
    image (pixels on the 122/255 cut, f32 against f64)."""
    dev = _port_eval(setup)
    host = _port_eval(setup, ev_kw={"device_paste": False})
    assert dev.det_correct == host.det_correct and dev.num_sent == 24
    np.testing.assert_array_equal(dev.seg_correct, host.seg_correct)
    assert abs(dev.cum_i - host.cum_i) <= 4 * 6
    assert abs(dev.cum_u - host.cum_u) <= 4 * 6


def test_images_beyond_the_paste_buffers_go_to_the_host(setup):
    """An original extent larger than (max_orig_h, max_orig_w) is pasted
    back on the host, as the JAX Evaluator routes it: with buffers of 64 x
    64 every image of the split (120 x 160) takes the host path, and
    scores exactly as device_paste=False (whose paste ignores the
    buffers)."""
    small = _port_eval(setup, max_orig_h=64, max_orig_w=64)
    host = _port_eval(setup, ev_kw={"device_paste": False})
    assert _state(small) == _state(host)
    assert small.seg_total == 24


def test_top_mode_draws_per_image(setup):
    """Test mode 'top' with fewer anchors (192, on a 64 x 64 canvas) than
    rpn_top_n (256): each image draws its random pad from a generator
    seeded from (cfg.seed, its uid), the uids given out in dispatch
    order. Two runs score the same; the images' generators differ; a
    scored split stays in range."""
    _, port_files, jax_files, cfg, model, _, _ = setup
    pcfg = to_port_cfg(cfg)
    pcfg.test.mode, pcfg.test.rpn_top_n = "top", 256
    pcfg.data.canvas_h = pcfg.data.canvas_w = 64
    old, model.cfg = model.cfg, pcfg
    try:
        runs = []
        for _ in range(2):
            ev = Evaluator(model, pcfg, device="cpu")
            loader = GtBatchLoader(*port_files, pcfg, seed=3)
            runs.append(ev.eval_split(loader.iter_test_batches(
                "val", buckets=BUCKETS)))
        assert ev._rng_uid == len(loader.split_ix["val"])
    finally:
        model.cfg = old
    assert runs[0] == runs[1]
    assert all(0.0 <= v <= 1.0 for v in runs[0].values())
    seeds = {ev._image_generator(u).initial_seed() for u in (1, 2, 3)}
    assert len(seeds) == 3
    pcfg.test.mode = "nms"
    assert Evaluator(model, pcfg, device="cpu")._image_generator(1) is None


TINY = ["data.canvas_h", "128", "data.canvas_w", "192",
        "model.backbone", "resnet26", "model.compute_dtype", "float32",
        "model.normalize_response", "true", "train.grad_clip_norm", "10",
        "train.learning_rate", "1e-5", "train.rpn_pre_nms_top_n", "512",
        "train.rpn_post_nms_top_n", "128", "train.roi_batch_size", "32",
        "test.rpn_pre_nms_top_n", "256", "test.rpn_post_nms_top_n", "32",
        "train.expressions_per_batch", "4", "train.snapshot_iters", "100"]


def _cli_args(setup, out):
    root = setup[0]
    return ["--variant", "response", "--prepro-dir",
            os.path.join(root, "prepro"), "--image-dir",
            os.path.join(root, "images", "train2014"), "--output-dir",
            str(out), "--set", *TINY]


def test_cli_train_then_eval_on_cpu(setup, tmp_path):
    """cli.train for 2 steps writes ckpt/iter_2; cli.eval restores it and
    appends one line a split to det_results.txt and mask_results.txt."""
    args = _cli_args(setup, tmp_path)
    losses = cli_train.main(args + ["--device", "cpu", "--max-iters", "2"])
    assert np.isfinite(losses["total_loss"])
    assert os.path.isdir(tmp_path / "ckpt" / "iter_2")
    res = cli_eval.main(args + ["--device", "cpu", "--splits", "val",
                                "testA", "--sent-buckets", "4", "8"])
    assert set(res) == {"val", "testA"}
    for name in ("det_results.txt", "mask_results.txt"):
        lines = (tmp_path / name).read_text().splitlines()
        assert len(lines) == 2 and "iter=2 split=val" in lines[0]
    assert all(0.0 <= v <= 1.0 for r in res.values() for v in r.values())
    for flag in ("--reference-exact", "--host-paste"):
        again = cli_eval.main(args + ["--device", "cpu", "--splits", "val",
                                      "--sent-buckets", "4", "8", flag])
        assert again["val"]["det_acc"] == res["val"]["det_acc"], flag


def test_cli_defaults_to_the_card(setup, tmp_path, monkeypatch):
    """Without --device both entry points ask for the card and refuse to
    run without one; `python -m` finds both."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _cli_args(setup, tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_train.main(args + ["--max-iters", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        cli_eval.main(args)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_train.main(args + ["--data-parallel", "2"])
    for mod in ("train", "eval"):
        out = subprocess.run(
            [sys.executable, "-m", f"lang2seg_tpu_torch.cli.{mod}", "--help"],
            cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
        assert "--device" in out.stdout
