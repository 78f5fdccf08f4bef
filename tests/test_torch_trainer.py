"""The port's file-backed training path on the CPU: `Trainer` over the
REFER loader with snapshots, resume, the LR-boundary snapshot, `keep`
and validation summaries; the checkpoint layout; the tolerant restore
and `load_params_file` on full reference-key checkpoints (the
fabricators of tests/test_convert_full.py), on a legacy protocol-2 file
with Python 2 string keys and on the JAX package's `.npz`; and
`restore_captioner` on the port's, the reference's and the JAX
package's captioner checkpoints.

The mini REFER split is the JAX package's `make_mini_refer` + `run_prepro`.
"""

import collections
import copy
import json
import os
import pickle
import struct
import types

import numpy as np
import pytest
import torch

from lang2seg_tpu.data.fixtures import make_mini_refer
from lang2seg_tpu.data.prepro import run_prepro
from lang2seg_tpu.engine.convert import (convert_captioner,
                                         convert_torch_state_dict)
from lang2seg_tpu.engine.train_captioner import _save_params_npz
from lang2seg_tpu_torch.config import apply_variant
from lang2seg_tpu_torch.config import Config as PortConfig
from lang2seg_tpu_torch.data.loader import GtBatchLoader
from lang2seg_tpu_torch.engine.checkpoint import (CheckpointManager,
                                                  tolerant_restore)
from lang2seg_tpu_torch.engine.convert import load_params_file
from lang2seg_tpu_torch.engine.train_captioner import (captioner_state_dict,
                                                       restore_captioner)
from lang2seg_tpu_torch.engine.trainer import Trainer
from lang2seg_tpu_torch.models.caption_zoo import setup_captioner
from lang2seg_tpu_torch.weights import init_params, state_dict_shapes
from tests.test_convert_full import (IGNORABLE, VOCAB, _maker,
                                     fabricate_7f_heads, fabricate_captioner,
                                     fabricate_encoder, fabricate_resnet_trunk)
from tests.test_torch_captioner import cap_config
from tests.test_torch_weights import response_config, to_port_cfg


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_trainer_data"))
    make_mini_refer(root)
    jp, hp = run_prepro(root, "refcoco", "unc", os.path.join(root, "prepro"),
                        count_threshold=0)
    cfg = to_port_cfg(response_config())       # word dropout on
    cfg.data.image_dir = os.path.join(root, "images", "train2014")
    cfg.model.vocab_size = 64                  # >= the fixture's vocabulary
    cfg.train.expressions_per_batch = 4
    cfg.train.images_per_batch = 2
    cfg.train.snapshot_iters = 2
    cfg.train.display = 1
    cfg.train.summary_interval = 1
    return cfg, jp, hp


def _trainer(env, out, seed=3, cfg=None, **kw):
    c, jp, hp = env
    cfg = cfg or c
    return Trainer(cfg, GtBatchLoader(jp, hp, cfg, seed=seed), str(out),
                   device="cpu", **kw)


def _events(out, tag=""):
    with open(os.path.join(str(out), "events.jsonl")) as f:
        return {e["step"]: e for e in map(json.loads, f) if e["tag"] == tag}


def _iters(out):
    return sorted(int(d.split("_")[1])
                  for d in os.listdir(os.path.join(str(out), "ckpt")))


def test_snapshot_resume_matches_uninterrupted(env, tmp_path):
    """2 steps, a snapshot, a fresh trainer (its loader seeded otherwise)
    resumed to 4 steps: exactly the losses, parameters and momentum of an
    uninterrupted 4-step run (word dropout and both samplers draw from
    the restored generator; the loader replays its iterators)."""
    a = _trainer(env, tmp_path / "a")
    a.train(4)
    b = _trainer(env, tmp_path / "b")
    b.train(2)
    assert _iters(tmp_path / "b") == [2]
    saved, host = CheckpointManager(str(tmp_path / "b" / "ckpt")).restore(2)
    assert saved["step"] == 2 and torch.equal(saved["generator"],
                                              b.generator.get_state())
    assert host["loader_state"]["iterators"] == b.loader.state_dict()[
        "iterators"]
    resumed = _trainer(env, tmp_path / "b", seed=99)
    resumed.train(4)
    assert resumed.state.step == 4 and _iters(tmp_path / "b") == [2, 4]
    ea, eb = _events(tmp_path / "a"), _events(tmp_path / "b")
    assert set(ea) == set(eb) == {1, 2, 3, 4}
    for it in (3, 4):
        assert ea[it] == eb[it], it
    sa = a.state.model.state_dict()
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(v, sa[k]), k
    oa = a.state.optimizer.state_dict()
    ob = resumed.state.optimizer.state_dict()
    for i, st in oa["state"].items():
        assert torch.equal(st["momentum_buffer"],
                           ob["state"][i]["momentum_buffer"])
    assert torch.equal(a.generator.get_state(), resumed.generator.get_state())


def test_lr_boundary_snapshot_and_resumed_lr(env, tmp_path):
    """A snapshot at the LR-decay step besides the cadence and the end
    (train_val.py:353-355); a run resumed there steps at the decayed LR."""
    cfg = copy.deepcopy(env[0])
    cfg.train.snapshot_iters = 100
    cfg.train.stepsize = (3,)
    cfg.train.learning_rate = 1e-4
    tr = _trainer(env, tmp_path, cfg=cfg)
    tr.train(4)
    assert _iters(tmp_path) == [3, 4]
    resumed = _trainer(env, tmp_path, cfg=cfg)
    assert resumed.try_resume() == 4
    assert resumed.state.step == 4
    lrs = {round(g["lr"] / g["lr_mult"], 12)
           for g in resumed.state.optimizer.param_groups}
    assert lrs == {1e-5}


def test_snapshot_keep(env, tmp_path):
    cfg = copy.deepcopy(env[0])
    cfg.train.snapshot_iters = 1
    cfg.train.snapshot_kept = 2
    cfg.train.summary_interval = 100
    _trainer(env, tmp_path, cfg=cfg).train(3)
    assert _iters(tmp_path) == [2, 3]
    assert not os.path.exists(os.path.join(str(tmp_path), "events.jsonl")) \
        or _events(tmp_path) == {}


def test_val_summaries_do_not_perturb(env, tmp_path):
    """Validation losses every summary_interval, under tag "val", drawn
    from a generator of their own: the training losses are the same bits
    with and without them (JAX tests/test_trainer.py:177)."""
    c, jp, hp = env
    _trainer(env, tmp_path / "a").train(2)
    _trainer(env, tmp_path / "b",
             val_loader=GtBatchLoader(jp, hp, c, seed=7)).train(2)
    assert _events(tmp_path / "a") == _events(tmp_path / "b")
    val = _events(tmp_path / "b", "val")
    assert set(val) == {1, 2}
    assert all(np.isfinite(e["total_loss"]) for e in val.values())


def test_trainer_refuses_unported_options(env):
    for section, key, value, item in (
            ("train", "steps_per_dispatch", 2, "Queue 1 #9"),
            ("train", "debug_save_dir", "dumps", "Queue 1 #5"),
            ("parallel", "num_data", 2, "Queue 1 #5")):
        cfg = copy.deepcopy(env[0])
        setattr(getattr(cfg, section), key, value)
        with pytest.raises(NotImplementedError, match=item):
            Trainer(cfg, None, device="cpu")


def test_checkpoint_manager(tmp_path):
    """iter_<n>/state.pth + host_state.pkl, written through .tmp, the
    newest `keep` kept, the newest found, weights-only loads."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.find_previous() is None
    for step in (1, 5, 3):
        mgr.save(step, {"w": torch.full((2,), float(step)), "step": step},
                 {"loader_state": {"pos": step}})
    assert sorted(os.listdir(str(tmp_path))) == ["iter_3", "iter_5"]
    assert sorted(os.listdir(str(tmp_path / "iter_5"))) == [
        "host_state.pkl", "state.pth"]
    assert mgr.find_previous() == 5
    state, host = mgr.restore(5)
    assert torch.equal(state["w"], torch.full((2,), 5.0))
    assert host["loader_state"] == {"pos": 5} and "np_random_state" in host


def test_tolerant_restore_reports_skips():
    target = {"a": torch.zeros(3, 3), "b": torch.zeros(4),
              "c": torch.ones(2, dtype=torch.float64)}
    loaded = {"a": np.full((3, 3), 7.0, np.float32), "b": torch.zeros(5),
              "d": torch.zeros(9)}
    out, skipped = tolerant_restore(target, loaded)
    assert torch.equal(out["a"], torch.full((3, 3), 7.0))
    assert out["b"] is target["b"] and out["c"] is target["c"]
    assert skipped == {"missing": ["c"], "mismatched": [("b", (5,), (4,))],
                       "unexpected": ["d"]}


def _flagship_cfg(variant):
    cfg = apply_variant(PortConfig(), variant)
    cfg.model.backbone = "resnet101"
    cfg.model.vocab_size = VOCAB
    cfg.model.cap_vocab_size = VOCAB
    return cfg


@pytest.mark.parametrize("variant", ["response", "cycle"])
def test_tolerant_restore_full_checkpoint(variant):
    """A complete reference-key checkpoint of the flagship network (and
    of the cycle network with its captioner) restores every entry of the
    port's state_dict; only the torchvision classifier is left over."""
    cfg = _flagship_cfg(variant)
    t = _maker(0)
    sd = {}
    fabricate_resnet_trunk(sd, t)
    fabricate_encoder(sd, t)
    fabricate_7f_heads(sd, t, c4_dim=1024, head_dim=2048)
    if variant == "cycle":
        fabricate_captioner(sd, t)
    target = {k: torch.empty(s, device="meta")
              for k, s in state_dict_shapes(cfg).items()}
    out, skipped = tolerant_restore(
        target, {k: torch.from_numpy(v) for k, v in sd.items()})
    assert skipped["missing"] == [] and skipped["mismatched"] == []
    assert all(k.startswith(IGNORABLE) for k in skipped["unexpected"])
    assert len(out) == len(target)


class _Py2Pickler(pickle._Pickler):
    """Protocol-2 pickler that writes str as Python 2 `str`
    (SHORT_BINSTRING / BINSTRING), as the reference's checkpoints hold
    their keys."""
    dispatch = dict(pickle._Pickler.dispatch)

    def save_py2_str(self, obj):
        b = obj.encode("latin1")
        if len(b) < 256:
            self.write(pickle.SHORT_BINSTRING + bytes([len(b)]) + b)
        else:
            self.write(pickle.BINSTRING + struct.pack("<i", len(b)) + b)
        self.memoize(obj)

    dispatch[str] = save_py2_str


def save_py2_legacy(obj, path):
    """torch's legacy (pre-zip) container, protocol 2, Python 2 strings."""
    mod = types.ModuleType("py2pickle")
    mod.Pickler = _Py2Pickler
    mod.dump = lambda o, f, protocol=2: _Py2Pickler(f, protocol).dump(o)
    torch.save(obj, path, pickle_module=mod, pickle_protocol=2,
               _use_new_zipfile_serialization=False)


def test_load_params_file_legacy_py2_pth(tmp_path):
    """A legacy protocol-2 file with Python 2 string keys loads weights
    only; a pickled module is refused unless the caller allows code."""
    cfg = to_port_cfg(response_config())
    src = init_params(cfg, 1)
    part = collections.OrderedDict(
        (k, v) for k, v in src.items()
        if k.startswith(("rnn_encoder.", "dynamic_fc", "rpn_")))
    path = str(tmp_path / "ref.pth")
    save_py2_legacy(part, path)
    with open(path, "rb") as f:
        assert b"U\x1crnn_encoder.embedding.weight" in f.read()
    loaded = load_params_file(path, cfg)
    assert list(loaded) == list(part)
    assert all(torch.equal(loaded[k], v) for k, v in part.items())
    target = init_params(cfg, 2)
    out, skipped = tolerant_restore(target, loaded)
    assert skipped["unexpected"] == [] and skipped["mismatched"] == []
    assert set(skipped["missing"]) == set(target) - set(part)
    assert all(torch.equal(out[k], part[k]) for k in part)

    module = torch.nn.Linear(3, 2)
    torch.save(module, str(tmp_path / "module.pth"))
    with pytest.raises(pickle.UnpicklingError):
        load_params_file(str(tmp_path / "module.pth"), cfg)
    got = load_params_file(str(tmp_path / "module.pth"), cfg,
                           allow_pickle=True)
    assert torch.equal(got["weight"], module.weight.detach())


def test_load_params_file_py2_non_ascii_key(tmp_path):
    """A Python 2 byte string beyond ASCII decodes as latin1 on the
    weights-only path (utf-8 refuses it)."""
    path = str(tmp_path / "ref.pth")
    save_py2_legacy(collections.OrderedDict(
        [("caf\xe9.weight", torch.arange(3.0))]), path)
    loaded = load_params_file(path, to_port_cfg(response_config()))
    assert list(loaded) == ["caf\xe9.weight"]
    assert torch.equal(loaded["caf\xe9.weight"], torch.arange(3.0))


def test_load_params_file_jax_npz(tmp_path):
    """The JAX package's flat params .npz -> the port's full state_dict,
    bit for bit (through weights.from_jax_params)."""
    jcfg = response_config()
    cfg = to_port_cfg(jcfg)
    sd = init_params(cfg, 3)
    tree = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                    jcfg)
    path = str(tmp_path / "params.npz")
    _save_params_npz(path, tree)
    loaded = load_params_file(path, cfg)
    assert set(loaded) == set(sd)
    for k, v in sd.items():
        assert torch.equal(loaded[k], v), k
    with pytest.raises(ValueError, match="unsupported"):
        load_params_file(str(tmp_path / "params.bin"), cfg)


@pytest.mark.parametrize("kind", ["port_pth", "reference_pth_bare",
                                  "reference_pth_prefixed", "jax_npz"])
def test_restore_captioner_file_kinds(tmp_path, kind):
    """restore_captioner reads the port's model-best.pth, the
    reference's (its captioner's own state_dict, Python 2 keys, bare or
    under caption_model.) and the JAX package's model-best.npz; each
    grafts the same weights into the cycle network's state_dict."""
    jcfg = cap_config()
    cfg = to_port_cfg(jcfg)
    net = init_params(cfg, 0)
    cap = setup_captioner(cfg.model)
    torch.manual_seed(5)
    for p in cap.parameters():
        torch.nn.init.normal_(p)
    want = captioner_state_dict(cap)
    path = str(tmp_path / ("model-best.npz" if kind == "jax_npz"
                           else "model-best.pth"))
    if kind == "port_pth":
        torch.save(want, path)
    elif kind == "reference_pth_bare":
        save_py2_legacy(collections.OrderedDict(cap.state_dict()), path)
    elif kind == "reference_pth_prefixed":
        save_py2_legacy(collections.OrderedDict(want), path)
    else:
        _save_params_npz(path, convert_captioner(
            {k: v.numpy() for k, v in want.items()}))
    new = restore_captioner(net, path)
    assert list(new) == list(net)
    for k in net:
        if k.startswith("caption_model."):
            assert torch.equal(new[k], want[k]), k
        else:
            assert new[k] is net[k]
