"""The fused gate's two kernels on the card, at the main path's shapes.

    python -m lang2seg_tpu_torch.tools.profile_gate [--reps 50]

Shapes (`SHAPES`): the forward as served, (16, 40, 64, 1024) bf16 through
a stride-0 map (all expressions of one image share its C4 map), K=7
sigmoid gate, normalized response; the forward and the backward as
trained, the same shape gathered from 2 images (a contiguous map per
expression). For each kernel and shape: its bound (`gate_bound`), then
the kernel checked against the plain version with `chip_smoke.py`'s
tolerances, the response within 1e-5 of its max as for bf16 maps there
(a kernel that fails or is out of tolerance is reported, left out of
the timing, and fails the run at its end), then timed three ways,
twice: CUDA events over back-to-back calls, the device time of
back-to-back calls (`profile_nms.device_ms`; the L2 is warm, as when the
backbone has just written the map), and the device time of single calls
with the 50 MB L2 flushed before each (`cold_device_ms`). Then each
kernel's registers and spills (`-Xptxas -v`, from build.log) and the
cycles a step of each phase, from the build with
-DFUSED_FILTER_PHASE_CLOCKS. Prints one JSON line last. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from ..ops import _build, fused_filter
from ..ops.fused_filter import (fused_dynamic_filter_bwd_plain,
                                fused_dynamic_filter_plain)
from .profile_nms import F32_FLOPS, HBM_BYTES_PER_S, device_ms, time_ms

# (name, expressions, H, W, C, K, gate, normalize, map): "broadcast" is one
# image's map read in place by every expression (serving), "gathered" a
# map per expression drawn from 2 images (training)
SHAPES = (("serve_fwd_16x40x64x1024", 16, 40, 64, 1024, 7, "sigmoid", True,
           "broadcast"),
          ("train_16x40x64x1024", 16, 40, 64, 1024, 7, "sigmoid", True,
           "gathered"))
PHASES = ("setup", "wait_loads", "contraction", "cross_warp_sum",
          "epilogue")


def gate_bound(e, h, w, c, k, elem, maps):
    """(bound ms, 'bytes' or 'operations', bytes, ops) of the forward:
    the map read once (`maps` of them: 1 broadcast, e gathered), filt and
    rfilt read, the gated map and the f32 response written; per pixel the
    K dot products over C, the gate multiply, masks, fuse and sigmoid."""
    byts = (maps * h * w * c * elem + e * c * k * 4 + e * k * 4
            + e * h * w * c * elem + e * h * w * 4)
    ops = e * h * w * (2 * c * k + c + 3 * k + 4)
    return _bound(byts, ops)


def gate_bwd_bound(e, h, w, c, k, elem, maps):
    """The same for the backward: conv (`maps` of them) and d_gated read,
    d_conv written, fused and d_resp read, filt and rfilt read, d_filt and
    d_rfilt written; per pixel the response recomputed (2CK), d_g (2C),
    d_conv (C(2K + 3)), d_filt (2CK), d_fused and d_rfilt (3K + 10)."""
    byts = ((maps + 2 * e) * h * w * c * elem + 2 * e * h * w * 4
            + 2 * (e * c * k + e * k) * 4)
    ops = e * h * w * (c * (6 * k + 5) + 3 * k + 10)
    return _bound(byts, ops)


def _bound(byts, ops):
    b_bytes, b_ops = byts / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return (max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops
            else "operations", byts, ops)


def gate_inputs(e, h, w, c, k, maps, dev, dtype=torch.bfloat16, seed=0):
    """The forward's and backward's inputs, drawn from a seed on the CPU:
    (conv, filt, rfilt, d_gated, d_resp); conv is a stride-0 broadcast of
    one image ("broadcast") or gathered from 2 images ("gathered")."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    img = (torch.randn((2, h, w, c), generator=g) * 2.0).to(dev, dtype)
    if maps == "broadcast":
        conv = img[:1].expand(e, h, w, c)
    else:
        idx = torch.randperm(e, generator=g) % 2
        conv = img[idx.to(dev)]
    filt = torch.tanh(torch.randn((e, c, k), generator=g)).to(dev)
    rfilt = (torch.tanh(torch.randn((e, k), generator=g)) if k == 7
             else torch.ones((e, 1))).to(dev)
    d_gated = torch.randn((e, h, w, c), generator=g).to(dev, dtype)
    d_resp = torch.randn((e, h, w, 1), generator=g).to(dev)
    return conv, filt, rfilt, d_gated, d_resp


def bf16_ulps_floored(got, want):
    """bf16 ulp distance in ulps of max(|want|, 2^-8 max|want|)
    (`chip_smoke.py` phase 4b)."""
    want = want.float()
    mag = torch.maximum(want.abs(), want.abs().max() * 2.0 ** -8)
    ulp = 2.0 ** (torch.floor(torch.log2(mag)) - 7)
    return float(((got.float() - want).abs() / ulp).max())


def bf16_ulp_distance(a, b):
    """Elementwise distance in bf16 representable steps."""
    def ordered(x):
        bits = x.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (ordered(a) - ordered(b)).abs()


def forward_errors(got, want, conv, gate):
    """(response error / max|response|, gated bf16 ulps given the kernel's
    own response: one rounding of the f32 product conv * g)."""
    (gk, rk), (_, rp) = got, want
    g_k = torch.sigmoid(rk) if gate == "sigmoid" else rk
    same_g = (conv.float() * g_k).to(torch.bfloat16)
    return (float((rk - rp).abs().max()) / float(rp.abs().max()),
            int(bf16_ulp_distance(gk.float(), same_g.float()).max()))


def backward_errors(got, want):
    """(d_conv floored bf16 ulps, d_filt and d_rfilt errors / their max)."""
    rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
           for a, b in zip(got[1:], want[1:])]
    return bf16_ulps_floored(got[0], want[0]), rel[0], rel[1]


def cold_device_ms(fn, reps, spin_cycles=40_000_000):
    """Mean device time of single calls of fn, each after the L2 was
    flushed (a 256 MB buffer zeroed; the card holds 50 MB of L2), timed by
    CUDA events around the call alone; the card spins while the host
    enqueues them, so the host's time is not counted."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(spin_cycles)
    for start, end in evs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / reps


def kernel_registers(log_path):
    """{kernel: (registers, stack frame bytes, spill store bytes, spill
    load bytes)} from an `nvcc -Xptxas -v` log, kernel names demangled
    where c++filt exists."""
    text = Path(log_path).read_text()
    out, name, frame = {}, None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)),) + frame
            name, frame = None, (0, 0, 0)
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out),
                               capture_output=True, text=True,
                               check=True).stdout.split("\n")
    except (OSError, subprocess.CalledProcessError):
        return out
    return {re.sub(r"\(anonymous namespace\)::|\(.*\)$", "", d): v
            for d, v in zip(names, out.values())}


def phase_cycles(calls):
    """Cycles a step of each phase (thread 0 of block (0, 0), clock64) of
    the forward and the backward, from the -DFUSED_FILTER_PHASE_CLOCKS
    build; `calls(lib)` runs both once. Set-up is per block, not a step."""
    lib = _build.load("fused_filter_clocks")
    fused_filter._bind(lib)
    lib.fused_filter_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.fused_filter_phase_clocks.restype = ctypes.c_int
    calls(lib)
    torch.cuda.synchronize()
    n = len(PHASES) + 2
    out = (ctypes.c_longlong * (2 * n))()
    if lib.fused_filter_phase_clocks(out) != 0:
        raise RuntimeError("fused_filter phase clocks: read failed")
    res = {}
    for i, which in enumerate(("forward", "backward")):
        vals = out[i * n:(i + 1) * n]
        steps = max(vals[len(PHASES)], 1)
        res[which] = {"steps": vals[len(PHASES)], "setup": vals[0],
                      **{p: vals[j] / steps
                         for j, p in enumerate(PHASES) if j}}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gate needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = {"port": fused_filter._lib()}
    logs = {"port": _build.library_path("fused_filter").with_name(
        "build.log")}
    result = {"device": smi, "sms": sms, "kernels": {},
              "registers": {v: kernel_registers(p) for v, p in logs.items()}}
    wrong = []                 # versions that failed or are out of tolerance
    for name, e, h, w, c, k, gate, norm, maps in SHAPES:
        conv, filt, rfilt, d_gated, d_resp = gate_inputs(e, h, w, c, k, maps,
                                                         dev)
        nmaps = 1 if maps == "broadcast" else e
        plan = {kind: fused_filter.launch_plan(kind, conv)
                for kind in ("forward", "backward")}
        print(f"[{name}] tile plans {plan}", flush=True)
        fargs = (conv, filt, rfilt, k, gate, norm)
        want_f = fused_dynamic_filter_plain(*fargs)
        fused = want_f[1]
        bargs = (conv, filt, rfilt, fused, d_gated, d_resp, k, gate, norm)
        kinds = {"forward": (gate_bound, fused_filter._launch_forward, fargs,
                             want_f)}
        if maps == "gathered":
            kinds["backward"] = (gate_bwd_bound, fused_filter._launch_backward,
                                 bargs, fused_dynamic_filter_bwd_plain(*bargs))
        for kind, (bound_fn, launch, a, want) in kinds.items():
            bound, by, byts, ops = bound_fn(e, h, w, c, k, 2, nmaps)
            calls = {}
            errs = {}
            for v, lib in libs.items():
                blocks = plan[kind]["blocks_per_expr"]
                call = (lambda lib=lib, b=blocks: launch(lib, b, *a))
                try:
                    got = call()
                    again = call()
                    torch.cuda.synchronize()
                except RuntimeError as exc:      # a failed build or launch
                    wrong.append(f"{v} {kind} on {name}: {exc}")
                    print(wrong[-1], flush=True)
                    continue
                if kind == "forward":
                    rerr, ulps = forward_errors(got, want, conv, gate)
                    errs[v] = {"resp_rel": rerr, "gated_ulps": ulps}
                    # chip_smoke's 1e-3, and 1e-5 for these bf16 maps
                    ok = rerr <= 1e-5 and ulps <= 1.0
                else:
                    ulps, df, drf = backward_errors(got, want)
                    same = all(torch.equal(x, y) for x, y in zip(got, again))
                    errs[v] = {"d_conv_ulps": ulps, "d_filt_rel": df,
                               "d_rfilt_rel": drf, "repeatable": same}
                    ok = ulps <= 2.0 and df <= 1e-3 and drf <= 1e-3 and same
                if ok:
                    calls[v] = call
                else:
                    wrong.append(f"{v} {kind} on {name}: {errs[v]}")
                    print(wrong[-1], flush=True)
            order = list(calls) + list(calls)[::-1]
            runs = {v: {"events": [], "device": [], "cold": []}
                    for v in calls}
            for v in order:
                runs[v]["events"].append(time_ms(calls[v], args.reps))
                runs[v]["device"].append(device_ms(calls[v], args.reps))
                runs[v]["cold"].append(cold_device_ms(calls[v],
                                                      max(args.reps // 2, 5)))
            row = {"bound_ms": bound, "bound_by": by, "bytes": byts,
                   "ops": ops, "errors": errs,
                   **{f"{m}_ms": {v: sum(r[m]) / len(r[m])
                                  for v, r in runs.items()}
                      for m in ("events", "device", "cold")},
                   "runs": runs}
            row["tile_plan"] = plan[kind]
            print(f"[{name} {kind}] bound {bound * 1e3:.2f} us ({by}); "
                  f"device ms {  {v: round(t, 4) for v, t in row['device_ms'].items()} }; "
                  f"cold-L2 ms {  {v: round(t, 4) for v, t in row['cold_ms'].items()} }; "
                  f"events ms {  {v: round(t, 4) for v, t in row['events_ms'].items()} }; "
                  f"errors {errs}", flush=True)
            result["kernels"][f"{name}_{kind}"] = row

        def both(lib, fargs=fargs, bargs=bargs, gathered=maps == "gathered",
                 plan=plan):
            fused_filter._launch_forward(
                lib, plan["forward"]["blocks_per_expr"], *fargs)
            if gathered:
                fused_filter._launch_backward(
                    lib, plan["backward"]["blocks_per_expr"], *bargs)
        cyc = phase_cycles(both)
        if maps != "gathered":
            cyc.pop("backward")
        result["kernels"][f"{name}_forward"]["cycles_a_step"] = cyc["forward"]
        if "backward" in cyc:
            result["kernels"][f"{name}_backward"]["cycles_a_step"] = \
                cyc["backward"]
        print(f"[{name}] cycles a step by phase (thread 0 of block 0): {cyc}",
              flush=True)
    for v, regs in result["registers"].items():
        for kname, (r, fr, st, ld) in regs.items():
            if "bfloat16, 7" in kname:          # the main path's variants
                print(f"[registers] {v} {kname}: {r} registers, stack "
                      f"frame {fr} B, spill stores {st} B, spill loads {ld} "
                      f"B", flush=True)
    print(json.dumps(result))
    if wrong:
        raise SystemExit(f"failed or out of tolerance (not timed): {wrong}")


if __name__ == "__main__":
    main()
