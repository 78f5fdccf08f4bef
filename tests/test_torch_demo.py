"""The port's visual demo and debug dumps against the JAX package's, on the
CPU: `utils/visualization.py` (its own PNG writer, the response-map and
top-channel dumps, cv2's thickness-2 rectangle in NumPy), `cli.demo` end
to end against the JAX `cli/demo.py`, and the Trainer's
`debug_save_dir` dumps.

The demo comparison gives both command lines the same tiny config as
`--set` overrides of tests/test_network.py::tiny_config's fields
(128x192 canvas, f32) and the same `--prepro-dir` (the port's
`run_prepro` over `data/fixtures.py::write_mini_refer`). The weights are
the ones the JAX demo draws with `create_train_state` (its RPN class
weights scaled by 100 for both, as tests/test_torch_slice.py does against
near-tied objectness), converted into a port snapshot for `--ckpt-dir`.
The JAX demo paints the class label with cv2.putText; the port paints no
text, so the JAX side is compared with its putText disabled (ROADMAP
Queue 3)."""

import json
import os
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jax

import lang2seg_tpu.engine.train_state as jtrain_state
import lang2seg_tpu.ops.boxes as jboxes
import lang2seg_tpu.utils.metrics as jmetrics
import lang2seg_tpu.utils.visualization as jvis
from lang2seg_tpu.cli import demo as jdemo
from lang2seg_tpu_torch.cli import demo
from lang2seg_tpu_torch.config import apply_variant, load_config
from lang2seg_tpu_torch.data.fixtures import write_mini_refer
from lang2seg_tpu_torch.data.prepro import run_prepro
from lang2seg_tpu_torch.data.synthetic import (FixedBatchLoader,
                                              synthetic_batch)
from lang2seg_tpu_torch.engine.checkpoint import CheckpointManager
from lang2seg_tpu_torch.engine.train_state import to_device
from lang2seg_tpu_torch.engine.trainer import Trainer
from lang2seg_tpu_torch.ops.boxes import decode_boxes
from lang2seg_tpu_torch.tools.tiny_step import tiny_config
from lang2seg_tpu_torch.utils.visualization import (
    _normalize_to_u8, decode_png, draw_boxes, encode_png, rectangle_mask,
    save_response_map, save_topk_channels, write_png)
from lang2seg_tpu_torch.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["data.canvas_h", "128", "data.canvas_w", "192",
        "model.backbone", "resnet26", "model.compute_dtype", "float32",
        "model.normalize_response", "true",
        "test.rpn_pre_nms_top_n", "256", "test.rpn_post_nms_top_n", "32"]
MOBILENET_POOL = ["model.backbone", "mobilenet_v1", "model.c4_feat_dim",
                  "512", "model.pooling_mode", "pool"]
# the mask tolerance of the port's comparisons (1e-3 in probability),
# in the demo's 0-255 units around its 122 cut
MASK_TOL = 255 * 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(seed):
    rng = np.random.RandomState(seed)
    return {"grey": rng.randint(0, 256, (37, 53), dtype=np.uint8),
            "bgr": rng.randint(0, 256, (29, 41, 3), dtype=np.uint8),
            "grey_1x1": np.full((1, 1), 7, np.uint8),
            "bgr_flat": np.zeros((16, 16, 3), np.uint8)}


@pytest.mark.parametrize("kind", ["grey", "bgr", "grey_1x1", "bgr_flat"])
def test_write_png_reads_back(kind, tmp_path):
    """write_png's file decoded by Pillow and by cv2 here, pixel for pixel,
    as the files Image.fromarray(..., "L").save and cv2.imwrite write of
    the same array; the port's own decoder reads all three of its own
    (the signature, IHDR, CRCs, filter-0 rows)."""
    a = _images(0)[kind]
    path = write_png(str(tmp_path / "port.png"), a)
    ref_cv2 = str(tmp_path / "cv2.png")
    cv2.imwrite(ref_cv2, a)
    if a.ndim == 2:
        ref_pil = str(tmp_path / "pil.png")
        Image.fromarray(a, "L").save(ref_pil)
        np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                      np.asarray(Image.open(ref_pil)))
        assert Image.open(path).mode == "L"
    else:
        assert Image.open(path).mode == "RGB"
        np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                      a[:, :, ::-1])
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  cv2.imread(ref_cv2, cv2.IMREAD_UNCHANGED))
    with open(path, "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read()), a)


def test_decode_png_refuses_damage():
    data = bytearray(encode_png(_images(1)["grey"]))
    assert decode_png(bytes(data)).shape == (37, 53)
    data[40] ^= 0xFF                               # inside the IDAT
    with pytest.raises((ValueError, zlib.error)):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a" + bytes(data[6:]))


def test_dumps_match_jax(tmp_path, rng):
    """save_response_map and save_topk_channels against the JAX package's
    (Pillow) on the same arrays: the same file names, the same decoded
    pixels; a flat map gives zeros in both."""
    resp = rng.randn(1, 8, 12, 1).astype(np.float32)
    conv = np.abs(rng.randn(8, 12, 32)).astype(np.float32)
    conv[:, :, 3] *= 10.0                          # the top channel
    for root, mod in (("jax", jvis), ("port", None)):
        save_r = mod.save_response_map if mod else save_response_map
        save_t = mod.save_topk_channels if mod else save_topk_channels
        save_r(resp, str(tmp_path / root), "iter5")
        save_r(np.ones((4, 4), np.float32), str(tmp_path / root), "flat")
        save_t(conv, str(tmp_path / root / "net_conv"), "iter5", k=5)
    for sub in ("", "net_conv"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub))
        for n in names:
            if n.endswith(".png"):
                np.testing.assert_array_equal(
                    np.asarray(Image.open(tmp_path / "port" / sub / n)),
                    np.asarray(Image.open(tmp_path / "jax" / sub / n)))
    assert "iter5_0_3.png" in os.listdir(tmp_path / "port" / "net_conv")
    assert not np.asarray(Image.open(tmp_path / "port" / "flat_0.png")).any()


@pytest.mark.parametrize("seed", range(4))
def test_draw_boxes_matches_cv2_rectangle(seed):
    """draw_boxes against cv2.rectangle(img, p1, p2, color, 2) on the same
    image, bit for bit: 30 boxes a seed, corners truncated to int,
    including boxes across the image's edges, off it, reversed, and 0 to 2
    pixels wide or high."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (60, 90, 3), dtype=np.uint8)
    boxes = rng.uniform(-30, 120, (30, 4)).astype(np.float32)
    boxes[::3, 2] = boxes[::3, 0] + rng.randint(0, 3, 10)
    boxes[1::3, 3] = boxes[1::3, 1] + rng.randint(0, 3, 10)
    for b in boxes:
        want = img.copy()
        cv2.rectangle(want, (int(b[0]), int(b[1])), (int(b[2]), int(b[3])),
                      (0, 255, 0), 2)
        np.testing.assert_array_equal(draw_boxes(img, b[None]), want)
    assert not rectangle_mask(10, 10, (-50, -50), (-20, -20)).any()


def test_stable_tokens_across_processes():
    """The port's hash tokens are the same in every process; the JAX
    demo's `hash(w)` changes with PYTHONHASHSEED (ROADMAP Queue 3)."""
    code = ("import sys; sys.path.insert(0, {repo!r}); "
            "from lang2seg_tpu_torch.cli.demo import stable_token; "
            "print([stable_token(w, 100) for w in 'the dog left'.split()], "
            "[1 + hash(w) % 99 for w in 'the dog left'.split()])")
    outs = [subprocess.run(
        [sys.executable, "-c", code.format(repo=REPO)], capture_output=True,
        text=True, check=True, timeout=120,
        env=dict(os.environ, PYTHONHASHSEED=str(s))).stdout for s in (1, 2)]
    port = [o.split("] [")[0] for o in outs]
    salted = [o.split("] [")[1] for o in outs]
    assert port[0] == port[1]
    assert salted[0] != salted[1]
    assert demo.stable_token("the", 100) == 1 + zlib.crc32(b"the") % 99


def test_demo_image_needs_cv2(monkeypatch, tmp_path):
    """--image reads through cv2, imported on call: without it the demo
    raises an ImportError that names it."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        demo.main(["--image", str(tmp_path / "x.jpg"), "--device", "cpu",
                   "--set", *TINY])


def test_demo_defaults_to_the_card(monkeypatch, tmp_path):
    """Without --device the demo asks for the card and refuses to run
    without one; `python -m` finds it and its --device flag."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        demo.main(["--out", str(tmp_path / "d.png"), "--set", *TINY])
    out = subprocess.run(
        [sys.executable, "-m", "lang2seg_tpu_torch.cli.demo", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    assert "--device" in out.stdout and "--ckpt-dir" in out.stdout


@pytest.fixture(scope="module")
def prepro_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("demo_refer"))
    write_mini_refer(root, ((60, 80), (80, 60), (64, 64)), (2, 3, 2),
                     ("train", "train", "val"))
    out = os.path.join(root, "prepro")
    run_prepro(root, "refcoco", "unc", out, count_threshold=0)
    return out


def _run_jax_demo(monkeypatch, argv):
    """The JAX demo with its weights' RPN class logits scaled by 100; the
    params it used, its decode_boxes' inputs, its boxes, mask and
    annotated image are recorded."""
    rec = {}
    real_state, real_decode = (jtrain_state.create_train_state,
                               jboxes.decode_boxes)
    real_recover, real_draw = jmetrics.recover_masks, jvis.draw_boxes

    def create_train_state(cfg, rng=None):
        model, tx, state = real_state(cfg, rng)
        params = jax.tree_util.tree_map(np.array, state.params)
        for k in ("kernel", "bias"):
            params["rpn_head"]["rpn_cls"][k] = \
                params["rpn_head"]["rpn_cls"][k] * 100.0
        rec["params"] = params
        return model, tx, state.replace(params=params)

    def decode(rois, deltas):
        rec["rois"], rec["deltas"] = np.asarray(rois), np.asarray(deltas)
        return real_decode(rois, deltas)

    def recover(*a):
        rec["mask"] = real_recover(*a)
        return rec["mask"]

    def draw(image, boxes, labels=None, color=(0, 255, 0)):
        rec["box"], rec["cls"] = np.asarray(boxes)[0], int(labels[0])
        return real_draw(image, boxes, None, color)   # no putText

    monkeypatch.setattr(jtrain_state, "create_train_state", create_train_state)
    monkeypatch.setattr(jboxes, "decode_boxes", decode)
    monkeypatch.setattr(jmetrics, "recover_masks", recover)
    monkeypatch.setattr(jvis, "draw_boxes", draw)
    jdemo.main(argv)
    return rec


@pytest.mark.parametrize("net", ["resnet_crop", "mobilenet_pool"])
def test_demo_matches_jax_demo(net, prepro_dir, tmp_path, monkeypatch):
    """Both demos on the synthetic fixture with the same weights,
    vocabulary and expression: the same class; the port's decode_boxes on
    the JAX demo's rois and deltas within 2 f32 ulps of its box, and the
    two boxes within 1e-2 px (the networks' outputs differ by f32 rounding);
    the annotated images pixel for pixel except at pixels whose mask value
    lies within 1e-3 (in probability) of the 122 cut, which are counted;
    the response maps' PNGs within 1 grey level."""
    sets = TINY + (MOBILENET_POOL if net == "mobilenet_pool" else [])
    with open(os.path.join(prepro_dir, "data.json")) as f:
        vocab = json.load(f)["word_to_ix"]
    words = [w for w in vocab if w != "<UNK>"]
    expr = " ".join(words[:3] + ["zebra"])           # one unknown word
    common = ["--expression", expr, "--prepro-dir", prepro_dir,
              "--variant", "response"]
    j_out = str(tmp_path / "jax" / "demo.png")
    os.makedirs(os.path.dirname(j_out))
    rec = _run_jax_demo(monkeypatch, common + ["--out", j_out, "--set",
                                               *sets])
    cfg = apply_variant(load_config(None, sets), "response")
    cfg.model.vocab_size = len(vocab)
    sd = from_jax_params(rec["params"], cfg)
    CheckpointManager(str(tmp_path / "ckpt")).save(0, {"model": sd})
    p_out = str(tmp_path / "port" / "demo.png")
    got = demo.main(common + ["--out", p_out, "--device", "cpu",
                              "--ckpt-dir", str(tmp_path / "ckpt"),
                              "--set", *sets])
    assert got["cls"] == rec["cls"]
    mine = decode_boxes(torch.from_numpy(rec["rois"].copy()),
                        torch.from_numpy(rec["deltas"].copy())).numpy()
    want = np.asarray(jboxes.decode_boxes(rec["rois"], rec["deltas"]))
    np.testing.assert_allclose(mine, want, rtol=2 * 2.0 ** -23,
                               atol=2 * 2.0 ** -23 * np.abs(want).max())
    np.testing.assert_allclose(got["box"], rec["box"], rtol=0, atol=1e-2)
    assert [int(v) for v in got["box"]] == [int(v) for v in rec["box"]]
    j_img = cv2.imread(j_out)
    p_img = cv2.imread(p_out)
    np.testing.assert_array_equal(p_img, got["image"])
    assert p_img.shape == j_img.shape == (480, 640, 3)
    differ = (p_img != j_img).any(-1)
    near = np.abs(rec["mask"][0] * 255 - 122) <= MASK_TOL
    assert not (differ & ~near).any(), int((differ & ~near).sum())
    painted = int((rec["mask"][0] * 255 > 122).sum())
    assert painted > 0 and (got["mask"] * 255 > 122).sum() == painted
    print(f"demo {net}: {int(differ.sum())} pixels differ, "
          f"{int(near.sum())} mask pixels within the tolerance of the cut, "
          f"{painted} painted")
    j_resp = np.asarray(Image.open(tmp_path / "jax" / "demo_response_0.png"))
    p_resp = np.asarray(Image.open(got["response"]))
    assert j_resp.shape == p_resp.shape == (8, 12)
    assert np.abs(j_resp.astype(int) - p_resp.astype(int)).max() <= 1


def test_trainer_debug_dumps(tmp_path):
    """A Trainer with `debug_save_dir` writes, after each validation batch,
    the first example's response map (`response/iter<it>_0.png`) and its 5
    highest-energy backbone channels (`net_conv/iter<it>_0_<ch>.png`), as
    the JAX Trainer names them; their pixels are the maps the model
    computes for that example in eval mode."""
    cfg = tiny_config("response")
    cfg.train.learning_rate = 1e-5
    cfg.train.display = cfg.train.summary_interval = 1
    cfg.train.debug_save_dir = str(tmp_path / "dbg")
    train = synthetic_batch(cfg, 2, 4, seed=1)
    val = synthetic_batch(cfg, 2, 4, seed=2)
    trainer = Trainer(cfg, FixedBatchLoader([train]), str(tmp_path / "out"),
                      val_loader=FixedBatchLoader([val]), device="cpu")
    trainer.train(2)
    assert sorted(os.listdir(tmp_path / "dbg" / "response")) == \
        ["iter1_0.png", "iter2_0.png"]
    names = sorted(os.listdir(tmp_path / "dbg" / "net_conv"))
    assert len(names) == 10 and all(n.startswith(("iter1_0_", "iter2_0_"))
                                    for n in names)
    model = trainer.state.model
    model.eval()
    b = to_device(val, "cpu")
    with torch.no_grad():
        net_conv = model.backbone.head(model._images(
            b["images"][b["img_idx"][:1].long()]))
        _, response = model._condition(net_conv, b["labels"][:1])
    model.train()
    with open(tmp_path / "dbg" / "response" / "iter2_0.png", "rb") as f:
        np.testing.assert_array_equal(
            decode_png(f.read()), _normalize_to_u8(response[0, :, :, 0]
                                                   .numpy()))
    conv = net_conv[0].numpy()
    top = np.argsort(-np.abs(conv).sum(axis=(0, 1)))[:5]
    for ch in top:
        with open(tmp_path / "dbg" / "net_conv" / f"iter2_0_{ch}.png",
                  "rb") as f:
            np.testing.assert_array_equal(decode_png(f.read()),
                                          _normalize_to_u8(conv[:, :, ch]))
