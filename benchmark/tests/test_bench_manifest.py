"""BENCHMARK.json against the rules its readers keep (names, units,
lengths, keys, bounds, the run budget), and the harness finding every
file of a cell by its name."""

from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "cell": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                    r"_rank$|head|expansion|per_tok)")


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(man):
    assert set(man) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(man["command"]) <= 32
    for word in man["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    # a full check of the largest benchmark later PRs may grow to (24
    # cells) fits its 43200 s
    runs = 2 + 14 * 24
    assert runs * (man["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs(man):
    assert 1 <= len(man["configs"]) <= 24
    files = set()
    for c in man["configs"]:
        assert set(c) == KEYS["config"], c["name"]
        assert NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTHS.search(k)
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in man["workloads"])


def test_cells(man):
    assert 1 <= len(man["workloads"]) <= 24
    configs = {c["name"] for c in man["configs"]}
    seen = set()
    for w in man["workloads"]:
        assert set(w) == KEYS["cell"], w["name"]
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["config"] in configs
        assert w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


def test_metrics(man):
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in man["workloads"]}
    assert 1 <= len(man["end_to_end"]) <= 16
    assert 1 <= len(man["per_layer"]) <= 128
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"], m["name"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"], m["name"]
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for c in cells:
        reported = {m["name"] for m in harness.metrics_of(man, c,
                                                          "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.metrics_of(man, c, "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in reported, (c, m["name"])


def test_files_resolve_by_name(man):
    for w in man["workloads"]:
        cfg = harness.config_file(man, w["config"])
        assert set(cfg["config"]) == {"model", "train", "test", "data"}
        traffic = harness.traffic_file(w["traffic"])
        assert (ROOT / "benchmark" / "drivers"
                / f"{traffic['entry']}.py").exists()
        limits = harness.limits_file(w["name"])["limits"]
        assert limits
        for m in harness.metrics_of(man, w["name"], "per_layer"):
            assert callable(harness.metric_reader(m["name"]).read)
    for name, op in harness.op_files().items():
        assert NAME.match(name) and len(op.ENTRY) == 2
        assert callable(op.keep) and callable(op.bound_s)


def test_config_files_are_the_flagship_presets(man):
    import dataclasses
    from lang2seg_tpu_torch.config import flagship_config
    for c in man["configs"]:
        body = json.loads((ROOT / c["file"]).read_text())
        want = dataclasses.asdict(flagship_config(body["variant"]))
        for part, values in body["config"].items():
            want_part = json.loads(json.dumps(want[part]))
            for key in body["reduced"]:
                group, leaf = key.split(".")
                if group == part:
                    want_part[leaf] = values[leaf]
            assert values == want_part, (c["name"], part)


@pytest.mark.parametrize("reference", [None, "response_b_ref"])
def test_a_cell_added_as_files_needs_no_edit(man, tmp_path, reference):
    """A configuration, a traffic mix, a per-layer metric, an op and a cell
    added as new files and new entries to a copy are found by name; so is
    a plain reference module that the configuration names."""
    copy = tmp_path / "repo"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*")
              if p.is_file()}
    new = json.loads(json.dumps(man))
    cfg = json.loads((ROOT / "benchmark/configs/response.json").read_text())
    cfg["name"] = "response_b"
    if reference:
        cfg["reference"] = reference
        (copy / f"benchmark/reference/{reference}.py").write_text(
            "from .model import *  # noqa: F401,F403\n")
    (copy / "benchmark/configs/response_b.json").write_text(json.dumps(cfg))
    (copy / "benchmark/traffic/serve.e4.json").write_text(json.dumps(
        dict(harness.traffic_file("serve.e16"), expressions=4)))
    (copy / "benchmark/limits/response_b.serve.e4.json").write_text(
        (ROOT / "benchmark/limits/response.serve.e16.json").read_text())
    (copy / "benchmark/metrics/window_s.serve_b.py").write_text(
        "def read(view):\n    return view['summary'].window_s\n")
    (copy / "benchmark/ops/extra_op.py").write_text(
        "ENTRY = ('lang2seg_tpu_torch.ops.nms', 'nms_padded')\n"
        "def keep(args, kwargs, out):\n    return None\n"
        "def bound_s(rec):\n    return 0.0\n")
    new["configs"].append(dict(man["configs"][0], name="response_b",
                               file="benchmark/configs/response_b.json"))
    new["workloads"].append({"name": "response_b.serve.e4",
                             "config": "response_b", "traffic": "serve.e4",
                             "chips": 1, "why": "a test cell"})
    new["per_layer"].append({"name": "window_s.serve_b", "unit": "s",
                             "better": "lower", "source": "device_trace",
                             "layer": "device", "moves": "request_ms_p50",
                             "workloads": ["response_b.serve.e4"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(new))
    man2 = harness.manifest(copy)
    cell = harness.cell(man2, "response_b.serve.e4")
    assert harness.config_file(man2, cell["config"], copy)["name"] == \
        "response_b"
    assert harness.traffic_file(cell["traffic"], copy)["expressions"] == 4
    assert harness.limits_file(cell["name"], copy)["limits"]
    layer = [m["name"] for m in harness.metrics_of(man2, cell["name"],
                                                   "per_layer")]
    assert layer == ["window_s.serve_b"]
    assert harness.metric_reader(layer[0], copy).read(
        {"summary": type("S", (), {"window_s": 2.5})()}) == 2.5
    assert "extra_op" in harness.op_files(copy)
    ref = harness.reference_of(harness.config_file(man2, "response_b", copy),
                               copy)
    name = reference or "model"
    assert Path(ref.__file__).name == f"{name}.py"
    assert harness.state_shapes(ref, cfg["config"]) == harness.state_shapes(
        harness.reference_of(harness.config_file(man, "response")),
        cfg["config"])
    for p, body in before.items():
        assert p.read_bytes() == body, f"{p} was edited"


def test_result_line_keys(tmp_path):
    """The last line's keys, from a run at a tiny size on the CPU."""
    from benchmark.run import run_cell
    from benchmark.tests.tiny import tiny_cell
    cfg, traffic = tiny_cell("response.serve.e16")
    out = run_cell("response.serve.e16", 2 ** 31 + 12345, 1.0, False,
                   device="cpu", cfg_file=cfg, traffic=traffic)
    res = json.loads(json.dumps(out["result"]))
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["metrics"]) == {"request_ms_p50", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == set(
        harness.limits_file("response.serve.e16")["limits"])


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lang2seg_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_and_a_reference_of_its_own():
    """No module under benchmark/ imports JAX or the JAX package (whole
    top-level names); benchmark/reference/ imports nothing of the
    program either."""
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert files
    for f in files:
        names = set(_imports(f))
        assert not names & FORBIDDEN, (f, names & FORBIDDEN)
        if "reference" in f.parts:
            assert "lang2seg_tpu_torch" not in names, f
            assert "benchmark" not in names, f
