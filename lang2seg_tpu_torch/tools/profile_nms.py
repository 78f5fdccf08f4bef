"""The NMS kernel on the card, at the main path's two shapes.

    python -m lang2seg_tpu_torch.tools.profile_nms [--clusters 1,4,6,8]
        [--baseline path/to/an/earlier/nms.cu]

On the two RPN draws of `chip_smoke.py` phase 3, (16, 6000) -> 300 as
served and (16, 12000) -> 2000 as trained, both at 0.7: per lane the
boxes kept and the last box examined, the pair tests greedy NMS needs
(`nms_pairs`) and the kernel's bound; then the kernel's time at each
cluster size (CTAs per lane), each result held bit for bit against the
plain version (a version that fails or differs is reported, left out
of the timing, and fails the run at its end); "wrapper" is
`nms_batched` with the cluster size it picks. Each version is timed
three ways: CUDA events over back-to-back calls (host time between calls
included) and its device time alone (`device_ms`), both in turns (each
one, then each in reverse order), and each kernel's own device time with
`torch.profiler`. With `--baseline`, an earlier `nms.cu` with the
two-pass C entry `nms_launch(boxes, valid, e, n, max_out, thresh,
scratch, keep_idx, keep_mask, stream)` is built, checked and timed too,
its time split by kernel. Last, the cycles a tile of each phase of the
kernel's tile loop (a build with -DNMS_PHASE_CLOCKS), at the wrapper's
cluster size, and that size for other lane counts. Prints one JSON line
last. Needs a CUDA device.

Also holds the draws and the edge cases that `chip_smoke.py` and the
tests share.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, nms_cuda
from ..ops.anchors import shifted_anchors
from ..ops.boxes import clip_boxes, decode_boxes
from ..ops.nms import nms_padded

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor)
# FLOP/s; NMS does its arithmetic in f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations of one +1-pixel IoU test (4 min/max, 4 sub/add for the
# overlap, 2 clamps, 1 mul, 1 add + 1 sub for the union, 1 div, 1 compare;
# box areas are per box, not per pair)
NMS_OPS_PER_PAIR = 15
TILE = 64


def rpn_draw(e, pre_n, seed, dev):
    """Score-sorted proposal boxes as the proposal layer makes them: an
    RPN draw over the 40x64x12 anchors of the 640x1024 canvas, decoded,
    clipped, stably sorted, top pre_n."""
    g = np.random.RandomState(seed)
    anchors = shifted_anchors(40, 64, 16, (4, 8, 16, 32), (0.5, 1.0, 2.0),
                              device=dev)
    n = anchors.shape[0]
    scores = torch.from_numpy(g.uniform(0, 1, (e, n)).astype(np.float32))
    deltas = torch.from_numpy((g.randn(e, n, 4) * 0.2).astype(np.float32))
    boxes = clip_boxes(decode_boxes(anchors, deltas.to(dev)),
                       torch.tensor(600.0, device=dev),
                       torch.tensor(1000.0, device=dev))
    order = torch.sort(-scores.to(dev), dim=1, stable=True).indices[:, :pre_n]
    return torch.gather(boxes, 1, order[..., None].expand(e, pre_n, 4)
                        ).contiguous()


# the main path's two shapes: (name, lanes, boxes, draw seed, thresh, max_out)
MAIN_SHAPES = (("rpn_16x6000_300", 16, 6000, 1, 0.7, 300),
               ("rpn_16x12000_2000", 16, 12000, 2, 0.7, 2000))


def lane_stats(keep_idx, keep_mask, n, max_out):
    """Per lane: boxes kept, and the last box greedy NMS examines (the
    max_out-th kept box, or the last box when it never gets there)."""
    ki, km = keep_idx.cpu().numpy(), keep_mask.cpu().numpy()
    kept = km.sum(1).astype(int).tolist()
    last = [int(ki[i][km[i]][-1]) if k == max_out else n - 1
            for i, k in enumerate(kept)]
    return kept, last


def nms_pairs(keep_idx, keep_mask, n, max_out):
    """IoU tests greedy NMS needs on this data: each box up to the last
    one processed against every kept box before it."""
    ki, km = keep_idx.cpu().numpy(), keep_mask.cpu().numpy()
    total = 0
    for lane in range(ki.shape[0]):
        kept = ki[lane][km[lane]].astype(np.int64)
        last = kept[-1] if len(kept) == max_out else n - 1
        total += int(np.sum(last - kept))
    return total


def nms_bound(keep_idx, keep_mask, n, max_out):
    """(bound ms, 'bytes' or 'operations', bytes, ops): the boxes and
    valid bits read once, the outputs written once; the pair tests this
    data needs at 15 f32 operations each."""
    e = keep_idx.shape[0]
    byts = e * n * 16 + e * n + e * max_out * 5
    ops = nms_pairs(keep_idx, keep_mask, n, max_out) * NMS_OPS_PER_PAIR
    b_bytes, b_ops = byts / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return (max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops
            else "operations", byts, ops)


def _rand(g, e, n, lim=100.0):
    xy = g.uniform(0, lim, (e, n, 2))
    wh = g.uniform(5, lim / 2, (e, n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _grid(cols, rows):
    """Boxes 12 px wide on a 20 px pitch: no two overlap, so all are kept."""
    xs, ys = np.meshgrid(np.arange(cols) * 20.0, np.arange(rows) * 20.0)
    return np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 12,
                     ys.ravel() + 12], 1).astype(np.float32)


def edge_cases(seed=0):
    """Draws at the edges of the kernel's tiles, lanes and frontier:
    [(name, boxes (E, N, 4) f32, valid (E, N) bool, thresh, max_out)]."""
    g = np.random.RandomState(seed)
    cases = []
    for n in (63, 64, 65, 129):
        valid = np.ones((2, n), bool)
        valid[1, ::5] = False
        cases.append((f"tile_edge_2x{n}", _rand(g, 2, n), valid, 0.5, n))
    grid = _grid(20, 10)                                     # 200 boxes
    two = np.stack([grid, _rand(g, 1, 200)[0]])
    ones = np.ones((2, 200), bool)
    # lane 0 keeps every box: its 64th kept box is the last of tile 0, its
    # 100th sits in the middle of tile 1
    cases.append(("max_out_at_tile_end_2x200_64", two, ones, 0.5, 64))
    cases.append(("max_out_mid_tile_2x200_100", two, ones, 0.5, 100))
    cases.append(("max_out_above_n_2x100_300", _rand(g, 2, 100),
                  np.ones((2, 100), bool), 0.5, 300))
    valid = np.ones((3, 300), bool)
    valid[1] = False
    cases.append(("invalid_lane_3x300_128", _rand(g, 3, 300), valid, 0.7,
                  128))
    for e in (1, 4, 8):
        cases.append((f"lanes_{e}x500_128", _rand(g, e, 500),
                      np.ones((e, 500), bool), 0.7, 128))
    grid = _grid(64, 40)                                     # 2560 boxes
    cases.append(("grid_frontier_2x2560_2000", np.stack([grid, grid[::-1]]),
                  np.ones((2, 2560), bool), 0.7, 2000))
    return cases


# ------------------------------------------------------- on the card only

def time_ms(fn, reps, warmup=1):
    """Mean time of fn over `reps` back-to-back calls between two CUDA
    events: the device's time, plus whatever the host adds between calls
    when it enqueues them slower than the device runs them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, spin_cycles=20_000_000):
    """Mean device time of fn over `reps` back-to-back calls, without the
    host's time between them: the card spins (torch.cuda._sleep, ~10 ms)
    while the host enqueues the calls, then runs them back to back between
    two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _baseline(path):
    """The two-pass kernel of an earlier nms.cu, built beside the port's
    own libraries; returns a wrapper with `nms_batched`'s signature."""
    src = Path(path).read_bytes()
    flags = _build._flags("nms")
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = _build.BUILD_DIR / f"baseline-{key}" / "libnms_base.so"
    if not lib_path.exists():
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *flags, "-o", str(lib_path), path],
                       check=True)
    lib = ctypes.CDLL(str(lib_path))
    p = ctypes.c_void_p
    lib.nms_launch.argtypes = [p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, p, p, p, p]
    lib.nms_launch.restype = ctypes.c_int

    def run(boxes, valid, thresh, max_out):
        e, n, _ = boxes.shape
        cols = (n + 63) // 64
        scratch = torch.empty(max(e * n * cols, 1), dtype=torch.int64,
                              device=boxes.device)
        ki = torch.empty((e, max_out), dtype=torch.int32, device=boxes.device)
        km = torch.empty((e, max_out), dtype=torch.bool, device=boxes.device)
        rc = lib.nms_launch(boxes.data_ptr(), valid.data_ptr(), e, n,
                            max_out, float(thresh), scratch.data_ptr(),
                            ki.data_ptr(), km.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline nms launch failed: cudaError {rc}")
        return ki, km

    return run


def device_ms_by_kernel(fn, reps):
    """Device ms per call of each NMS kernel fn launches (torch.profiler:
    the kernels' own durations, without the host's time between calls)."""
    from torch.profiler import ProfilerActivity, profile

    from .profile_train import _device_us
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[-2].split("::")[-1]: _device_us(e) / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "nms" in e.key}


PHASES = ("frontier_test", "cluster_barrier", "hit_words_dsmem",
          "tile_pairs", "walk", "append_next_tile")


def phase_cycles(boxes, valid, thresh, max_out, cluster):
    """Cycles per tile of each phase of the kernel's tile loop, as thread 0
    of lane 0's first CTA sees them (clock64), from the build of nms.cu
    with -DNMS_PHASE_CLOCKS; and the tiles that lane walked."""
    lib = _build.load("nms_clocks")
    p = ctypes.c_void_p
    lib.nms_launch.argtypes = [p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, ctypes.c_int, p, p, p]
    lib.nms_launch.restype = ctypes.c_int
    lib.nms_phase_clocks.argtypes = [p]
    lib.nms_phase_clocks.restype = ctypes.c_int
    e, n, _ = boxes.shape
    ki = torch.empty((e, max_out), dtype=torch.int32, device=boxes.device)
    km = torch.empty((e, max_out), dtype=torch.bool, device=boxes.device)
    rc = lib.nms_launch(boxes.data_ptr(), valid.data_ptr(), e, n, max_out,
                        float(thresh), cluster, ki.data_ptr(), km.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    out = (ctypes.c_longlong * (len(PHASES) + 1))()
    if rc != 0 or lib.nms_phase_clocks(out) != 0:
        raise RuntimeError("nms phase clocks: launch or read failed")
    tiles = out[len(PHASES)]
    return {"tiles": tiles,
            **{k: out[i] / max(tiles, 1) for i, k in enumerate(PHASES)}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clusters", default="1,4,6,8")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_nms needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    versions = {"wrapper": nms_cuda.nms_batched}   # its own cluster size
    versions.update({f"cluster{c}": functools.partial(nms_cuda._launch,
                                                      cluster=c)
                     for c in map(int, args.clusters.split(","))})
    if args.baseline:
        versions = {"baseline": _baseline(args.baseline), **versions}
    # the wrapper's cluster size by lane count, at the training shape
    lanes = (1, 4, 8, 15, 16, 17, 22, 23, 32)
    result = {"device": smi, "shapes": {}, "cluster_size_by_lanes": {
        e: nms_cuda.cluster_size(dev, e, 12000, 2000) for e in lanes}}
    print(f"cluster size by lanes: {result['cluster_size_by_lanes']}",
          flush=True)
    wrong = []                  # versions that differ from the plain one
    for name, e, n, seed, thr, max_out in MAIN_SHAPES:
        boxes = rpn_draw(e, n, seed, dev)
        valid = torch.ones((e, n), dtype=torch.bool, device=dev)
        pi, pm = nms_padded(boxes, valid, thr, max_out)
        kept, last = lane_stats(pi, pm, n, max_out)
        bound, by, byts, ops = nms_bound(pi, pm, n, max_out)
        row = {"cluster_size": nms_cuda.cluster_size(dev, e, n, max_out),
               "kept_per_lane": kept, "last_examined_per_lane": last,
               "tiles_examined_per_lane": [x // TILE + 1 for x in last],
               "pairs": ops // NMS_OPS_PER_PAIR, "bytes": byts,
               "bound_ms": bound, "bound_by": by, "ms": {}}
        calls = {}
        for v, fn in versions.items():
            call = (lambda fn=fn: fn(boxes, valid, thr, max_out))
            try:
                ki, km = call()
                torch.cuda.synchronize()
            except RuntimeError as exc:          # a failed build or launch
                wrong.append(f"{v} on {name}: {exc}")
                print(wrong[-1], flush=True)
                continue
            if torch.equal(ki, pi) and torch.equal(km, pm):
                calls[v] = call
            else:
                wrong.append(f"{v} on {name}: differs")
        order = list(calls) + list(calls)[::-1]
        runs = {v: [] for v in calls}
        device = {v: [] for v in calls}
        for v in order:
            runs[v].append(time_ms(calls[v], args.reps))
            device[v].append(device_ms(calls[v], args.reps))
        row["ms"] = {v: sum(t) / len(t) for v, t in runs.items()}
        row["ms_runs"] = runs
        row["device_ms"] = {v: sum(t) / len(t) for v, t in device.items()}
        row["device_ms_runs"] = device
        # each kernel's own duration (torch.profiler): splits the
        # baseline's time by pass
        row["by_kernel_ms"] = {v: device_ms_by_kernel(calls[v], 20)
                               for v in calls}
        row["cycles_per_tile"] = phase_cycles(boxes, valid, thr, max_out,
                                              row["cluster_size"])
        print(f"[{name}] wrapper's cluster size {row['cluster_size']}; "
              f"kept/lane {kept}; last examined/lane {last}; "
              f"bound {bound * 1e3:.3f} us ({by}); ms "
              f"{ {k: round(t, 4) for k, t in row['ms'].items()} }; device "
              f"ms {  {k: round(t, 4) for k, t in row['device_ms'].items()} };"
              f" device ms by kernel {row['by_kernel_ms']}; cycles a tile at "
              f"the wrapper's size {row['cycles_per_tile']}", flush=True)
        result["shapes"][name] = row
    print(json.dumps(result))
    if wrong:
        raise SystemExit(f"failed or differ from the plain version (not "
                         f"timed): {wrong}")


if __name__ == "__main__":
    main()
