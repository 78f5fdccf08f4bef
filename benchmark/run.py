"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's configuration with random weights from the seed, warms
up the cell's own shapes, measures for `--seconds`, checks what the timed
path produced against the plain reference, and prints one JSON object as
the last line of standard output; the numbers compared, each beside its
limit, are the last lines of standard error. With `--trace 1` the window
runs under `torch.profiler` and the line carries the cell's per-layer
metrics, the device's busy and window seconds and the breakdown.
Needs as many CUDA devices as the cell names; exits 1 without them, and
exits 1 if JAX or the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs() -> None:
    """Kernel caches of the libraries the program may use, at fixed paths
    inside the checkout (the program's own nvcc builds live in
    lang2seg_tpu_torch/_build/)."""
    base = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Context:
    """What a driver is given: the configuration tree, the plain
    reference module that the configuration names (`ref`), the traffic,
    the seed, the device, and the weights on demand (drawn anew from the
    seed each time, so the reference gets the program's weights without
    keeping a copy through the window)."""

    def __init__(self, cfg_file: Dict, traffic: Dict, seed: int,
                 seconds: float, device: str, root: Path = ROOT):
        from . import harness
        self.cfg_tree = cfg_file["config"]
        self.ref = harness.reference_of(cfg_file, root)
        self.traffic = traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.cuda = device.startswith("cuda")

    def weights(self):
        from . import harness
        from .traffic_gen import sub_seed
        return harness.make_weights(
            harness.state_shapes(self.ref, self.cfg_tree), self.cfg_tree,
            sub_seed(self.seed, 7), self.device, self.ref.frozen_statistics)

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            import torch
            torch.cuda.empty_cache()


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             cfg_file: Optional[Dict] = None,
             traffic: Optional[Dict] = None,
             t_start: float = T_START) -> Dict:
    """One run of a cell: the result object (without printing it) and
    the checks under `checks`. `cfg_file` / `traffic` replace the cell's
    files (the tests' small sizes)."""
    import torch
    from . import check as chk
    from . import harness
    from .trace import OpTimer, summarize

    man = harness.manifest(root)
    cell = harness.cell(man, cell_name)
    cfg_file = cfg_file or harness.config_file(man, cell["config"], root)
    traffic = traffic or harness.traffic_file(cell["traffic"], root)
    limits = harness.limits_file(cell_name, root)
    ctx = Context(cfg_file, traffic, seed, seconds, device, root)
    drv = harness.driver(traffic["entry"]).Driver(ctx)

    timer = None
    if trace:
        timer = OpTimer()
    drv.setup()
    ops = harness.op_files(root) if trace else {}
    for name, op in ops.items():
        timer.wrap(importlib.import_module(op.ENTRY[0]), op.ENTRY[1], name,
                   op.keep)
    ctx.sync()
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if ctx.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        timer.recording = True
    with torch.profiler.record_function("bench.window"):
        drv.window(seconds)
        ctx.sync()
    if prof is not None:
        timer.recording = False
        prof.__exit__(None, None, None)
        timer.undo()

    n_dev = int(cell.get("chips", 1))
    dev_info = harness.device_info(n_dev) if ctx.cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1,
        "memory_peak_bytes": 0}
    e2e = drv.end_to_end()
    attempted, failed = drv.attempted()
    window_s = drv.window_s

    metrics: Dict[str, Dict] = {}
    extra: Dict = {}
    if trace:
        summary = summarize(prof)
        bounds = {name: sum(ops[name].bound_s(rec) for rec in recs)
                  for name, recs in timer.calls.items()}
        del prof
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        extra["breakdown"] = {"device_ops": summary.device_ops,
                              "idle_gaps": summary.idle_gaps}
        view = {"summary": summary, "bounds": bounds,
                "flops": drv.flops_in_window()}
        for m in harness.metrics_of(man, cell_name, "per_layer"):
            value = harness.metric_reader(m["name"], root).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        print(f"trace: op calls {dict((k, len(v)) for k, v in timer.calls.items())}, "
              f"launches {summary.op_launches}, device s {summary.op_device_s}, "
              f"bounds s {bounds}", file=sys.stderr, flush=True)
        timer.calls.clear()
    else:
        for m in harness.metrics_of(man, cell_name, "end_to_end"):
            if m["name"] == "setup_s":
                metrics[m["name"]] = {"value": setup_s, "unit": "s"}
            elif e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    drv.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = drv.check()
    checks = chk.with_limits(numbers, limits["limits"])
    correct = harness.checks_ok(checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info, **extra,
              "checks": {c["name"]: [c["value"], c["limit"]]
                         for c in checks}}
    return {"result": result, "checks": checks, "numbers": numbers,
            "window_s": window_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    from . import harness
    man = harness.manifest()
    chips = int(harness.cell(man, args.workload).get("chips", 1))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 1
    try:
        import lang2seg_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 1
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    forbidden = harness.forbidden_modules()
    if forbidden:
        print(f"benchmark: JAX or the JAX package was loaded: {forbidden}",
              file=sys.stderr)
        return 1
    res = out["result"]
    for m in res["metrics"].values():
        if not math.isfinite(m["value"]):
            m["value"] = None
    sys.stdout.flush()
    harness.print_checks(out["checks"])
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
