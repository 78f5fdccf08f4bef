"""What every cell shares: finding its files by name, the program's
configuration, the weights drawn on the device, the result line.

A cell of `BENCHMARK.json` names a configuration and a traffic mix; the
harness reads `benchmark/configs/<config>.json`, `benchmark/traffic/<mix>
.json` (whose `entry` names the driver in `benchmark/drivers/`),
`benchmark/limits/<cell>.json` (the limit of each number the check
compares), for each per-layer metric, `benchmark/metrics/<metric>.py`,
and the plain reference module that the configuration names
(`reference_of`). A cell added as files needs no edit here.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lang2seg_tpu")


def manifest(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def config_file(man: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in man["configs"]:
        if c["name"] == name:
            return read_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str, root: Path = ROOT) -> Dict:
    return read_json(root / "benchmark" / "traffic" / f"{name}.json")


def limits_file(cell_name: str, root: Path = ROOT) -> Dict:
    return read_json(root / "benchmark" / "limits" / f"{cell_name}.json")


def metrics_of(man: Dict, cell_name: str, kind: str) -> List[Dict]:
    """The end_to_end or per_layer metrics that a cell reports."""
    return [m for m in man[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def load_module(path: Path):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "metrics" / f"{name}.py")


def op_files(root: Path = ROOT) -> Dict:
    """Every op the traced run times: `benchmark/ops/<op>.py`, each with
    the program entry it wraps (`ENTRY`), what a call's bound reads
    (`keep`) and the bound (`bound_s`)."""
    return {p.stem: load_module(p)
            for p in sorted((root / "benchmark" / "ops").glob("*.py"))
            if not p.stem.startswith("_")}


def driver(entry: str):
    return importlib.import_module(f"benchmark.drivers.{entry}")


_REFERENCES: Dict[Path, object] = {}


def reference_of(cfg_file: Dict, root: Path = ROOT):
    """The plain reference module that a configuration file names under
    `"reference"`: `benchmark/reference/<name>.py`, `model` where the key
    is absent (what it exports: `benchmark/reference/__init__.py`). The
    one place in the harness that finds it; a file of another checkout
    (the tests' copies) is loaded once, inside this package's
    `reference`, so that it can import the plain parts of `model.py`."""
    name = cfg_file.get("reference", "model")
    path = root / "benchmark" / "reference" / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise FileNotFoundError(
            f"configuration {cfg_file.get('name')!r} names the reference "
            f"{name!r}, but there is no file {path}")
    path = path.resolve()
    if path.parent == Path(__file__).resolve().parent / "reference":
        return importlib.import_module(f"{__package__}.reference.{name}")
    if path not in _REFERENCES:
        spec = importlib.util.spec_from_file_location(
            f"{__package__}.reference.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _REFERENCES[path] = mod
    return _REFERENCES[path]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the program's configuration
# ---------------------------------------------------------------------------

def _dotted(tree: Dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _dotted(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def program_config(cfg_tree: Dict, seed: int):
    """The program's Config holding every value of the configuration
    file's `config`, with `seed` (the dropout and sampling generator's
    seed) from the run's seed."""
    from lang2seg_tpu_torch.config import Config, apply_overrides
    pairs = []
    for k, v in _dotted(cfg_tree):
        pairs += [k, tuple(v) if isinstance(v, list) else v]
    cfg = apply_overrides(Config(), pairs)
    cfg.seed = int(seed)
    return cfg


def generator_seed(seed: int) -> int:
    from .traffic_gen import sub_seed
    return sub_seed(seed, 0)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

_TRUNC_STD = 0.87962566103423978      # std of N(0, 1) truncated to +-2


def _rule(key: str, cfg: Dict):
    """(kind, scale) of a state-dict entry: the distributions of the
    measured package's random initialization (lecun-normal truncated at 2
    std for convolutions and dense layers, normal for the RPN, class and
    mask heads (0.01), box deltas (0.001) and embeddings, uniform for the
    LSTM, zero biases, frozen BatchNorm of unit scale and zero shift, its
    statistics set by the reference module's `frozen_statistics`)."""
    leaf = key.rsplit(".", 1)[-1]
    m = cfg["model"]
    if ".bn" in key or ".downsample.1." in key or key.startswith("resnet.bn"):
        return ("const", 1.0 if leaf in ("weight", "running_var") else 0.0)
    if key.startswith("resnet."):
        return ("lecun", None)
    if leaf.startswith("bias"):
        return ("const", 0.0)
    if key == "rnn_encoder.embedding.weight":
        return ("normal", 1.0 / math.sqrt(m["word_embedding_size"]))
    if key.startswith("rnn_encoder.rnn."):
        return ("uniform", 1.0 / math.sqrt(m["rnn_hidden_size"]))
    if key == "caption_model.embed.0.weight":
        return ("normal", 0.01)
    if key.startswith(("rpn_", "cls_score_net", "mask_")):
        return ("normal", 0.01)
    if key.startswith("bbox_pred_net"):
        return ("normal", 0.001)
    return ("lecun", None)


def make_weights(shapes: Dict[str, tuple], cfg: Dict, seed: int, device,
                 statistics) -> Dict[str, "torch.Tensor"]:
    """Every entry drawn from one uniform tensor of a CUDA (or CPU)
    generator seeded from `seed`, transformed in place, in f32 on
    `device`; then `statistics(out, cfg, seed, device)`, the reference
    module's `frozen_statistics`, sets what the network freezes."""
    import torch
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    u = torch.rand(total, generator=g, device=device)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    out, off = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        x = u[off:off + n].view(shape)
        off += n
        kind, scale = _rule(key, cfg)
        if kind == "const":
            x.fill_(scale)
        elif kind == "uniform":
            x.mul_(scale)
        elif kind == "normal":
            x.mul_(2.0).sub_(1.0).clamp_(-1 + 1e-7, 1 - 1e-7).erfinv_() \
                .mul_(math.sqrt(2.0) * scale)
        else:
            fan_in = math.prod(shape[1:])
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            x.mul_(2.0 * (1.0 - 2.0 * lo)).add_(2.0 * lo - 1.0).erfinv_() \
                .mul_(math.sqrt(2.0) * std)
        out[key] = x
    statistics(out, cfg, seed, device)
    return out


def state_shapes(ref, cfg_tree: Dict) -> Dict[str, tuple]:
    """Key -> shape of the network's state dict, from the reference
    module's `Reference`."""
    import torch
    with torch.device("meta"):
        net = ref.Reference(cfg_tree)
    return {k: tuple(t.shape) for k, t in net.reference_state_keys().items()}


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

def quantile(values: List[float], q: float) -> Optional[float]:
    """The q-quantile of the sorted values, linear between ranks."""
    if not values:
        return None
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def device_info(count: int) -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def checks_ok(checks: List[Dict]) -> bool:
    return all(c["value"] is not None and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in checks)


def print_checks(checks: List[Dict]) -> None:
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
