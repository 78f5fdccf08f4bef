"""Each configuration names its plain reference module, and the weights,
the FLOP count and the checks all go through it: a second module named
by a tiny configuration runs a serving and a training cell on the CPU;
an unknown name fails with the file it looked for; the ResNet-C4
configurations draw the weights and count the FLOPs they did before the
lookup existed; and no file of the harness imports `reference.model`
but through the lookup."""

from __future__ import annotations

import ast
import math
import shutil
from pathlib import Path

import pytest

from benchmark import flops, harness
from benchmark.run import Context, run_cell
from benchmark.tests.tiny import tiny_cell, tiny_config

ROOT = harness.ROOT
HERE = Path(__file__).resolve().parent

# computed before the lookup was written, with the harness as it was then
# (Context(tiny configuration, {}, 123456789, 1.0, "cpu").weights(): the
# float64 sum and sum of squares over every entry; count.serve_flops and
# count.train_flops at the tiny configuration)
PINNED = {
    "response": {"n": 126, "sum": 171052.12139202445,
                 "sumsq": 67144515.40032186, "serve_1x4": 84070780928,
                 "serve_1x1": 21708379136, "train_2x4": 263379329024},
    "cycle_response": {"n": 145, "sum": 171065.35260991685,
                       "sumsq": 67152819.46784417, "serve_1x4": 84070780928,
                       "serve_1x1": 21708379136, "train_2x4": 303231037440},
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_resnet_configurations_are_unchanged(name):
    from benchmark.flops import count
    cfg = tiny_config(harness.config_file(harness.manifest(), name))
    ctx = Context(cfg, {}, 123456789, 1.0, "cpu")
    assert ctx.ref.__name__ == "benchmark.reference.model"
    sd = ctx.weights()
    want = PINNED[name]
    assert len(sd) == want["n"]
    total = sum(float(t.double().sum()) for t in sd.values())
    squares = sum(float(t.double().pow(2).sum()) for t in sd.values())
    assert math.isclose(total, want["sum"], rel_tol=1e-12)
    assert math.isclose(squares, want["sumsq"], rel_tol=1e-12)
    c = cfg["config"]
    assert count.serve_flops(ctx.ref, c, 1, 4) == want["serve_1x4"]
    assert count.serve_flops(ctx.ref, c, 1, 1) == want["serve_1x1"]
    assert count.train_flops(ctx.ref, c, 2, 4) == want["train_2x4"]


def test_an_unknown_reference_names_its_file():
    cfg = dict(harness.config_file(harness.manifest(), "response"),
               reference="no_such_network")
    with pytest.raises(FileNotFoundError) as err:
        harness.reference_of(cfg)
    assert str(Path("benchmark", "reference", "no_such_network.py")) in \
        str(err.value)


def _tree_with_counting(tmp_path: Path) -> Path:
    copy = tmp_path / "repo"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    shutil.copy(HERE / "counting_reference.py",
                copy / "benchmark" / "reference" / "counting.py")
    return copy


# traced, so that the window's FLOPs are counted; one training step a
# chunk keeps the window short
CELLS = {"response.serve.e16": ("test_forward", "condition", "mfu.serve"),
         "response.train.2x16": ("train_forward", "train_forward",
                                 "mfu.train")}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_second_reference_module_is_used_throughout(cell, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(flops, "CACHE", tmp_path / "flops")
    copy = _tree_with_counting(tmp_path)
    cfg, traffic = tiny_cell(cell, copy)
    cfg["reference"] = "counting"
    seconds = 2.0  # both sampled requests served, also on a busy host
    if traffic["entry"] == "train":
        traffic["chunk_steps"] = 1
        seconds = 0.5
    out = run_cell(cell, 2 ** 33 + 5, seconds, True, device="cpu", root=copy,
                   cfg_file=cfg, traffic=traffic)
    ref = harness.reference_of(cfg, copy)
    assert Path(ref.__file__) == (copy / "benchmark" / "reference"
                                  / "counting.py").resolve()
    counted, checked, mfu = CELLS[cell]
    log = ref.LOG
    # the weights: shapes from its Reference on the meta device, then its
    # frozen statistics, once for the program and once for the check
    assert log.count(("init", "float32", "meta")) >= 3
    assert log.count(("frozen_statistics", "cpu")) == 2
    # the FLOP count: one forward on the meta device
    assert (counted, "meta") in log
    assert out["result"]["metrics"][mfu]["value"] > 0
    assert list(flops.CACHE.glob("*.json"))
    # the check: its Reference on the CPU
    assert ("init", "float32", "cpu") in log and (checked, "cpu") in log
    assert out["result"]["correct"] is True, out["result"]["checks"]


def _imported(path: Path):
    """Absolute names of the modules a file imports, relative imports
    resolved against the file's package."""
    package = list(path.relative_to(ROOT).parent.parts)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level \
                else []
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod
            yield from (f"{mod}.{a.name}" for a in node.names)


def test_only_the_lookup_imports_a_reference():
    """Outside benchmark/reference/, nothing imports a reference module
    or names the file of one: the harness's `reference_of` finds it by
    the configuration's name."""
    files = [f for f in sorted((ROOT / "benchmark").rglob("*.py"))
             if "reference" not in f.relative_to(ROOT).parts
             and f != Path(__file__).resolve()]
    assert len(files) > 20
    for f in files:
        for name in _imported(f):
            assert not name.startswith("benchmark.reference"), (f, name)
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not node.value.endswith("model.py"), f
