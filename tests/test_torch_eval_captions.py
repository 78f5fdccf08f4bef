"""The port's caption scorer (`cli/eval_captions.py::score_caption_split`)
against the JAX package's `cli/eval_captions.py` flow, at the tiny `cycle`
config with a small att2in2 captioner over a mini REFER split built in
memory (f32 canvases):
  * on a one-image split the same beam decodes and the same scores, float
    for float;
  * on a two-image split the JAX flow keys each row by its index within
    its image, so that the first image's decodes are scored against the
    second image's sentences; the port keys rows by a running index and
    scores each decode against its own sentence;
  * the command line on the CPU, a decoder without a beam search, and the
    card refusal.

The JAX flow is the body of JAX `cli/eval_captions.py::main` (:73-95)
over the same batches, with the same weights (the logit layer x 4, so
that the beams stand apart)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lang2seg_tpu.engine.evaluator import _host_expand_bank as j_expand
from lang2seg_tpu.engine.train_captioner import (
    extract_caption_features as jextract_caption_features)
from lang2seg_tpu.utils.caption_metrics import RefEvaluation as JRefEvaluation
from lang2seg_tpu_torch.cli import eval_captions
from lang2seg_tpu_torch.data.fixtures import mini_refer_split
from lang2seg_tpu_torch.data.loader import CycleBatchLoader
from lang2seg_tpu_torch.utils.caption_metrics import RefEvaluation
from tests.test_torch_cycle import cycle_config
from tests.test_torch_weights import shared_weights, to_port_cfg

BEAM = 3
METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr",
           "METEOR")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def split_loader(cfg, refs_per_image, seed):
    """A CycleBatchLoader over a val split of one 120 x 160 image per
    entry of `refs_per_image`, 2 sentences a ref."""
    info, labels, read = mini_refer_split(
        ((120, 160),) * len(refs_per_image), refs_per_image,
        ("val",) * len(refs_per_image), sents_per_ref=2, seed=seed)
    return CycleBatchLoader(info, labels, to_port_cfg(cfg), seed=0,
                            read_image=read)


@pytest.fixture(scope="module")
def cap_setup():
    """A `cycle` model (captioner vocabulary = the split's 24 words) with
    shared weights, the logit layer x 4 in both packages."""
    cfg = cycle_config("cycle", vocab_size=24, cap_vocab_size=24)
    cfg.data.wire_uint8_images = False
    model, jmodel, params = shared_weights(cfg, seed=3)
    with torch.no_grad():
        model.caption_model.logit.weight.mul_(4.0)
    params["captioner"]["logit_w"] = params["captioner"]["logit_w"] * 4.0
    return cfg, model, jmodel, jax.tree_util.tree_map(jnp.asarray, params)


def jax_flow(cfg, jmodel, params, loader, split):
    """JAX cli/eval_captions.py's loop over `loader`'s test batches:
    (preds, gt_refs, the decoded rows of each image)."""
    preds, gt_refs, decoded = [], [], []
    for batch in loader.iter_test_batches(split):
        batch = j_expand(batch)
        dev = {k: jnp.asarray(v) for k, v in batch.items()
               if k in ("images", "gt_masks")}
        dev["img_idx"] = jnp.zeros((batch["labels"].shape[0],), jnp.int32)
        with jax.default_matmul_precision("float32"):
            fc, att = jextract_caption_features(jmodel, params, dev, cfg)
            seqs, _ = jmodel.apply(
                {"params": params}, fc, att, BEAM,
                method=lambda mdl, f, a, b: mdl.captioner.sample_beam(f, a,
                                                                      b))
        decoded.append(np.asarray(seqs)[np.flatnonzero(batch["sent_valid"])])
        for i in np.flatnonzero(batch["sent_valid"]):
            sent = loader.decode_labels(np.asarray(seqs)[i][None])[0]
            preds.append({"ref_id": int(i), "sent": sent})
            gt_refs.append({"ref_id": int(i), "sentences": [
                {"sent": loader.decode_labels(batch["labels"][i][None])[0]}]})
    return preds, gt_refs, decoded


def port_decodes(model, loader, split):
    """The port's beam decodes of each image's valid rows."""
    from lang2seg_tpu_torch.engine.evaluator import _host_expand_bank
    from lang2seg_tpu_torch.engine.train_captioner import \
        extract_caption_features
    out = []
    for batch in loader.iter_test_batches(split):
        batch = _host_expand_bank(batch)
        fc, att = extract_caption_features(model, {
            "images": torch.from_numpy(batch["images"]),
            "gt_masks": torch.from_numpy(batch["gt_masks"]),
            "img_idx": torch.zeros(batch["labels"].shape[0],
                                   dtype=torch.long)})
        seqs, _ = model.caption_model.sample_beam(fc, att, BEAM)
        out.append(seqs.numpy()[np.flatnonzero(batch["sent_valid"])])
    return out


def test_one_image_split_equals_jax(cap_setup):
    cfg, model, jmodel, params = cap_setup
    loader = split_loader(cfg, (3,), seed=4)
    preds, gt_refs, jdec = jax_flow(cfg, jmodel, params, loader, "val")
    model.eval()
    pdec = port_decodes(model, loader, "val")
    assert len(pdec) == len(jdec) == 1
    np.testing.assert_array_equal(pdec[0], jdec[0])
    want = JRefEvaluation(gt_refs, preds).evaluate()
    got = eval_captions.score_caption_split(model, loader, "val", BEAM,
                                            device="cpu")
    assert list(got) == list(want) == list(METRICS)
    for k in METRICS:
        assert got[k] == want[k], (k, got[k], want[k])
    assert len(preds) == 6 and any(p["sent"] for p in preds)


def test_two_image_split_keys(cap_setup):
    """Two images of 4 and 6 rows (in the loader's order): the JAX flow
    keys each row by its index within its image, so the GT table keeps
    the last image's sentence for keys 0-3 and the first image's 4 rows
    are scored against the second image's sentences (no KeyError: every
    key some image has is in the table). The port scores every decode
    against its own sentence."""
    cfg, model, jmodel, params = cap_setup
    model.eval()
    loader = split_loader(cfg, (3, 2), seed=5)
    preds, gt_refs, jdec = jax_flow(cfg, jmodel, params, loader, "val")
    pdec = port_decodes(model, loader, "val")
    assert [len(d) for d in jdec] == [4, 6]
    for p, j in zip(pdec, jdec):
        np.testing.assert_array_equal(p, j)
    got = eval_captions.score_caption_split(model, loader, "val", BEAM,
                                            device="cpu")
    rows = [dict(p, ref_id=n) for n, p in enumerate(preds)]
    own = [dict(g, ref_id=n) for n, g in enumerate(gt_refs)]
    assert got == RefEvaluation(own, rows).evaluate()
    # JAX: key k's sentence is the last image's row k
    table = {g["ref_id"]: g for g in gt_refs}
    assert len(table) == 6 < len(preds) == 10
    theirs = [dict(table[p["ref_id"]], ref_id=n) for n, p in enumerate(preds)]
    assert sum(t != o for t, o in zip(theirs, own)) == 4
    wrong = JRefEvaluation(gt_refs, preds).evaluate()
    assert wrong == RefEvaluation(theirs, rows).evaluate()
    assert wrong != got


def test_cli_on_cpu(cap_setup, monkeypatch, tmp_path, capsys):
    """python -m lang2seg_tpu_torch.cli.eval_captions over a prepro'd split
    (the loader patched to the in-memory one), from a params file, on the
    CPU: one line of metrics a split, the scores of score_caption_split."""
    cfg, model, _, _ = cap_setup
    loader = split_loader(cfg, (2, 1), seed=6)
    monkeypatch.setattr(eval_captions, "open_loader",
                        lambda cls, d, c: loader)
    params = tmp_path / "params.pth"
    torch.save(model.state_dict(), str(params))
    overrides = ["data.canvas_h", "128", "data.canvas_w", "192",
                 "model.backbone", "resnet26", "model.compute_dtype",
                 "float32", "data.wire_uint8_images", "false",
                 "model.vocab_size", "24", "model.cap_vocab_size", "24"]
    for k in ("cap_rnn_size", "cap_input_encoding_size", "cap_att_hid_size",
              "cap_seq_length"):
        overrides += [f"model.{k}", str(getattr(cfg.model, k))]
    out = eval_captions.main([
        "--variant", "cycle", "--output-dir", str(tmp_path / "o"),
        "--device", "cpu", "--params", str(params), "--beam-size",
        str(BEAM), "--splits", "val", "--set"] + overrides)
    want = eval_captions.score_caption_split(model, loader, "val", BEAM,
                                             device="cpu")
    assert out["val"] == want
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("refcoco_unc val ")]
    assert len(lines) == 1 and "CIDEr=" in lines[0]
    with pytest.raises(SystemExit):
        eval_captions.main(["--variant", "response", "--device", "cpu"])


def test_refuses_teacher_forced_decoder_and_missing_card(cap_setup,
                                                         monkeypatch):
    from lang2seg_tpu_torch.models.network import build_model
    cfg, model, _, _ = cap_setup
    loader = split_loader(cfg, (1,), seed=7)
    pcfg = to_port_cfg(cycle_config("cycle", vocab_size=24,
                                    cap_vocab_size=24,
                                    caption_model="topdown"))
    topdown = build_model(pcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="teacher-forced"):
        eval_captions.score_caption_split(topdown, loader, "val",
                                          device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        eval_captions.score_caption_split(model, loader, "val")


def test_uint8_canvas_features(cap_setup):
    """The loader's default wire is the uint8 canvas: the port's caption
    features subtract the means from it, as from its f32 copy (within
    1e-4 of the max |value|); the JAX package's extract_caption_features,
    which its eval_captions calls, feeds the uint8 canvas to the backbone
    as it is."""
    from lang2seg_tpu_torch.engine.train_captioner import \
        extract_caption_features
    cfg, model, jmodel, params = cap_setup
    model.eval()
    r = np.random.RandomState(8)
    u8 = r.randint(0, 256, (1, 128, 192, 3)).astype(np.uint8)
    f32 = u8.astype(np.float32) - np.asarray(cfg.data.pixel_means_bgr,
                                             np.float32)
    masks = np.zeros((2, 128, 192), np.uint8)
    masks[0, 20:90, 30:120] = 1
    masks[1, 40:128, 100:192] = 1
    feats = {}
    for name, img in (("u8", u8), ("f32", f32)):
        feats[name] = extract_caption_features(model, {
            "images": torch.from_numpy(img),
            "gt_masks": torch.from_numpy(masks),
            "img_idx": torch.zeros(2, dtype=torch.long)})
    for a, b in zip(feats["u8"], feats["f32"]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    with jax.default_matmul_precision("float32"):
        jfc, _ = jextract_caption_features(jmodel, params, {
            "images": jnp.asarray(u8), "gt_masks": jnp.asarray(masks),
            "img_idx": jnp.zeros((2,), jnp.int32)}, cfg)
    ref = feats["f32"][0].numpy()
    assert np.abs(np.asarray(jfc) - ref).max() > 1e-2 * np.abs(ref).max()
