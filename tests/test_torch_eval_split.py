"""The port's `Evaluator.eval_split` against the JAX package's over a mini
REFER split (bucketed test batches with the ref-deduped mask bank), on
the same weights; and the train and eval command lines end to end on
the CPU.

The shared RPN class weights are scaled by 100 in both packages, as in
tests/test_torch_slice.py, so that near-tied objectness scores at the
random init do not reorder between the frameworks."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from lang2seg_tpu.data.fixtures import make_mini_refer
from lang2seg_tpu.data.loader import GtBatchLoader as JGtBatchLoader
from lang2seg_tpu.data.prepro import run_prepro
from lang2seg_tpu.engine.evaluator import Evaluator as JaxEvaluator
from lang2seg_tpu.utils.metrics import SegEvalAccumulator as JaxAccumulator
from lang2seg_tpu_torch.cli import eval as cli_eval
from lang2seg_tpu_torch.cli import train as cli_train
from lang2seg_tpu_torch.data.loader import GtBatchLoader
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
    jp, hp = run_prepro(root, "refcoco", "unc", os.path.join(root, "prepro"),
                        count_threshold=0)
    cfg = response_config()
    cfg.data.image_dir = os.path.join(root, "images", "train2014")
    cfg.model.vocab_size = 64
    model, jmodel, params = shared_weights(cfg, seed=2, scale_rpn_cls=100.0)
    return root, jp, hp, cfg, model, jmodel, params


def _port_eval(setup, pipeline_depth=4, **data_kw):
    _, jp, hp, cfg, model, _, _ = setup
    pcfg = to_port_cfg(cfg)
    for k, v in data_kw.items():
        setattr(pcfg.data, k, v)
    loader = GtBatchLoader(jp, hp, pcfg, seed=3)
    acc = SegEvalAccumulator()
    ev = Evaluator(model, pcfg, device="cpu")
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
    _, jp, hp, cfg, _, jmodel, params = setup
    acc = _port_eval(setup)
    jl = JGtBatchLoader(jp, hp, cfg, seed=3)
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


def test_eval_split_restores_mode_and_refuses_chunks(setup):
    _, jp, hp, cfg, model, _, _ = setup
    pcfg = to_port_cfg(cfg)
    ev = Evaluator(model, pcfg, device="cpu")
    model.train()
    loader = GtBatchLoader(jp, hp, pcfg, seed=3)
    s = ev.eval_split(loader.iter_test_batches("val", buckets=BUCKETS))
    assert model.training
    model.eval()
    assert all(0.0 <= v <= 1.0 for v in s.values())
    with pytest.raises(NotImplementedError, match="Queue 1 #4"):
        ev.eval_split([], images_per_dispatch=2)


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


def test_cli_defaults_to_the_card(setup, tmp_path, monkeypatch):
    """Without --device both entry points ask for the card and refuse to
    run without one; `python -m` finds both."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _cli_args(setup, tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_train.main(args + ["--max-iters", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        cli_eval.main(args)
    with pytest.raises(NotImplementedError, match="Queue 1 #5"):
        cli_train.main(args + ["--data-parallel", "2"])
    for mod in ("train", "eval"):
        out = subprocess.run(
            [sys.executable, "-m", f"lang2seg_tpu_torch.cli.{mod}", "--help"],
            cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
        assert "--device" in out.stdout
