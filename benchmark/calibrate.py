"""Readings the limits of `benchmark/limits/<cell>.json` are set from.

    python3 -m benchmark.calibrate --workload <cell> --seeds A,B,... \
        [--control-seeds C,D,...] [--fault frozen|half|answer] \
        [--seconds S] [--out PATH]

For each of `--seeds`, one run of the cell (a short window, the check as
a run makes it) with the program as it is, or with `--fault` planted
under its timed path; for each of `--control-seeds`, the control: the
reference in fp8 in the program's place, judged by the same comparison
(no window). All in one process. Prints, and writes to `--out`, every
number of every seed and, per number, the largest reading of the program
and the smallest of the control. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from .run import Context, _cache_dirs, run_cell
    _cache_dirs()
    import torch
    from . import faults, harness
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    man = harness.manifest()
    cell = harness.cell(man, args.workload)
    out = {"workload": args.workload, "fault": args.fault or None,
           "device": torch.cuda.get_device_name(0), "program": {},
           "control": {}}
    undo = faults.plant(args.fault) if args.fault else None
    try:
        for s in seeds:
            t0 = time.perf_counter()
            res = run_cell(args.workload, s, args.seconds, False,
                           t_start=time.perf_counter())
            out["program"][s] = res["numbers"]
            print(f"seed {s}: {out['program'][s]} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        if undo is not None:
            undo()
    for s in controls:
        t0 = time.perf_counter()
        ctx = Context(harness.config_file(man, cell["config"]),
                      harness.traffic_file(cell["traffic"]), s, args.seconds,
                      "cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        drv = harness.driver(ctx.traffic["entry"]).Driver(ctx)
        drv.setup(program=False)
        judged = drv.control()
        out["control"][s] = drv.check(judged)
        del drv, judged
        ctx.free()
        print(f"control {s}: {out['control'][s]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    names = sorted({k for v in list(out["program"].values())
                    + list(out["control"].values()) for k in v})
    out["summary"] = {
        k: {"program_max": max((v[k] for v in out["program"].values()
                                if k in v), default=None),
            "control_min": min((v[k] for v in out["control"].values()
                                if k in v), default=None)}
        for k in names if not k.startswith("diag.")}
    print(json.dumps(out["summary"], indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
