"""Eval throughput of the evaluator's modes on the card.

    python -m lang2seg_tpu_torch.tools.profile_eval [--passes 3]

Scores the eval mix of the JAX package's `bench.py::_measure_eval` with
the flagship `response` model at full width (random weights from a
seed): 8 images of 3, 6, 9, 13, 8, 5, 11 and 4 valid sentences, padded to
the sentence buckets (4, 8, 16), with the ref-deduped mask bank (refs of
3 sentences) and uint8 canvases, im_scale 1.2 on 640 x 1024 paste
buffers; the 8 images three times a pass (24 images, 177 valid
sentences). The batches are built here (the port keeps its own copy of
that function) as the loader writes them: an integer scaled extent with
the rounded pixel means beyond it, so that the extent-crop wire scores
exactly as the full canvas.

For each mode, `images_per_dispatch` 1 or 4 x the extent crop on or off
x staged uploads on or off, it runs one checked pass (the accumulator
state; each dispatch's device span, images, sentences and its NMS and
gate launches; the host syncs PyTorch's sync debug mode reports inside a
dispatch; the bytes copied host -> device; the peak device memory), then
`--passes` timed passes (valid expressions/s and images/s, best and
median), then one pass under torch.profiler (the device's idle share of
the pass: the time no kernel or copy runs, over the pass's host window).
Every mode must score the det_correct and seg_correct of one image a
dispatch with the crop off, and each valid sentence of each image as it
does: the same selected box within `BOX_TOL` pixels and I / U pixel counts
within 4; the crop on must leave the state and every sentence of the
crop off bit for bit. Prints a line a mode and one JSON line with
everything. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from ..config import Config, flagship_config
from ..data.synthetic import synthetic_batch, uint8_canvas
from ..engine.evaluator import Evaluator
from ..models.network import build_model
from ..utils.metrics import SegEvalAccumulator
from ..utils.trace import counters

BUCKETS = (4, 8, 16)
REAL_COUNTS = (3, 6, 9, 13, 8, 5, 11, 4)
# the largest gap, in pixels, between a sentence's selected box in two
# modes: at 4 images a dispatch the head's f32 sums run over 4 times the
# rows and may take another order (0.0043 px measured on an H100); a
# wrong map, extent or GT row moves a box by whole pixels
BOX_TOL = 1e-2
# (images_per_dispatch, extent crop, staged uploads)
MODES = tuple((k, crop, staged) for k in (1, 4) for crop in (True, False)
              for staged in (True, False))


def eval_config() -> Config:
    """The flagship config with paste buffers that fit the mix's original
    extents (scaled extents up to the canvas, over im_scale 1.2)."""
    cfg = flagship_config()
    cfg.data.max_orig_h, cfg.data.max_orig_w = 640, 1024
    return cfg


def eval_batch(cfg: Config, seed: int, n_real: int,
               buckets=BUCKETS) -> Dict[str, np.ndarray]:
    """One image of `n_real` valid sentences padded to the smallest
    fitting bucket, as `bench.py::_measure_eval` builds it, in the
    loader's wire formats: a uint8 canvas with the rounded pixel means
    beyond the integer scaled extent, GT boxes and masks shared by refs
    of 3 sentences (the mask bank: R = S // 2 rows when the refs fit
    there, else S, and each sentence's row)."""
    s_pad = min(b for b in buckets if b >= n_real)
    b = synthetic_batch(cfg, 1, s_pad, seed=seed)
    hw = np.round(b["im_hw"]).astype(np.float32)
    sh, sw = int(hw[0, 0]), int(hw[0, 1])
    canvas = uint8_canvas(cfg, b["images"])
    means = np.round(np.asarray(cfg.data.pixel_means_bgr)).astype(np.uint8)
    canvas[:, sh:] = means
    canvas[:, :, sw:] = means
    masks = b["gt_masks"]
    masks[:, sh:] = 0
    masks[:, :, sw:] = 0
    ref_of = np.arange(s_pad) // 3
    half = max(1, s_pad // 2)
    rows = half if ref_of[n_real - 1] + 1 <= half else s_pad
    ref_of = np.minimum(ref_of, rows - 1).astype(np.int32)
    bank = np.zeros((rows,) + masks.shape[1:], np.uint8)
    gt_boxes = b["gt_boxes"].copy()
    for i in range(s_pad):
        if i % 3 == 0:
            bank[ref_of[i]] = masks[i]
        gt_boxes[i] = b["gt_boxes"][(ref_of[i] * 3) % s_pad]
    return {"images": canvas, "im_hw": hw, "labels": b["labels"],
            "gt_boxes": gt_boxes, "im_scale": np.float32(1.2),
            "sent_valid": np.arange(s_pad) < n_real,
            "gt_mask_bank": bank, "mask_ref_idx": ref_of}


def eval_mix(cfg: Config, repeats: int = 3) -> List[Dict[str, np.ndarray]]:
    """The mix's 8 images, `repeats` times over."""
    return [eval_batch(cfg, s, n) for s, n in enumerate(REAL_COUNTS)] \
        * repeats


def _state(acc):
    return (acc.num_sent, acc.det_correct, acc.cum_i, acc.cum_u,
            tuple(int(x) for x in acc.seg_correct), acc.seg_total)


def checked_pass(ev: Evaluator, batches, k: int, staged: bool) -> Dict:
    """One pass with every dispatch recorded: (images, sentences, NMS
    launches, gate launches, device span ms) each, the host syncs the
    sync debug mode reports inside the dispatches, the bytes copied host
    -> device and the pass's peak device memory; and each valid
    sentence's selected box and I / U pixel counts (`sentences`, keyed
    "image:sentence" by the image's place in the pass and the sentence's
    slot). The kernels'
    launches over the pass are the counters' change (`launches`)."""
    real, real_drain = ev._dispatch_staged, ev._drain_chunk
    spans, syncs, sentences = [], [], {}
    uid0 = ev._rng_uid

    def launches():
        c = counters()
        return c.get("nms.launches", 0), c.get("gate.launches", 0)

    def recorded(st):
        c0 = launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rec = real(st)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        end.record()
        syncs.extend(str(w.message) for w in caught if
                     "synchronizing CUDA operation" in str(w.message))
        spans.append((len(st["chunk"]), st["s"],
                      *(b - a for a, b in zip(c0, launches())), start, end))
        return rec

    def drained(rec, acc):
        n = real_drain(rec, acc)
        sel = rec["sel"].cpu().numpy().reshape(n, rec["s"], 4)
        inter = rec["inter"].cpu().numpy().reshape(n, rec["s"])
        union = rec["union"].cpu().numpy().reshape(n, rec["s"])
        for d, uid in enumerate(rec["uids"]):
            for i in np.flatnonzero(rec["valid_flags"][d]):
                sentences[f"{uid - uid0 - 1}:{i}"] = (
                    sel[d, i].tolist(), int(inter[d, i]), int(union[d, i]))
        return n

    acc = SegEvalAccumulator()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bytes0 = counters().get("eval.h2d_bytes", 0)
    ev._dispatch_staged, ev._drain_chunk = recorded, drained
    launches0 = launches()
    t0 = time.perf_counter()
    try:
        ev.eval_split(batches, images_per_dispatch=k, stage_uploads=staged,
                      acc=acc)
    finally:
        del ev._dispatch_staged, ev._drain_chunk
    torch.cuda.synchronize()
    return {"state": _state(acc), "summary": acc.summary(),
            "sentences": sentences,
            "seconds": time.perf_counter() - t0,
            "launches": tuple(b - a for a, b in zip(launches0,
                                                    launches())),
            "dispatches": [(n, s, nms, gate, a.elapsed_time(b))
                           for n, s, nms, gate, a, b in spans],
            "host_syncs": syncs,
            "h2d_bytes": counters().get("eval.h2d_bytes", 0) - bytes0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def device_busy(prof) -> Dict[str, float]:
    """Device time of a profile: the union of its kernel and copy
    intervals (a copy on the copy stream may overlap a kernel), and the
    copies' own sum, in ms."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("torch.profiler recorded no device event")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    copies = sum(e.time_range.end - e.time_range.start for e in events
                 if e.name.startswith("Memcpy"))
    return {"busy_ms": busy / 1e3, "copy_ms": copies / 1e3}


# the hand kernels by the names of their device functions (a launch a
# wrapper call; the gate's backward also runs `fused_filter_bwd_reduce`)
KERNEL_NAMES = {"nms": ("nms_frontier_kernel",),
                "fused_filter": ("fused_filter_mma_kernel",
                                 "fused_filter_kernel"),
                "fused_filter_bwd": ("fused_filter_bwd_kernel",),
                "roi_pool": ("roi_pool_fwd_",),
                "roi_pool_bwd": ("roi_pool_bwd_",),
                "roi_crop": ("roi_crop_fwd_",),
                "roi_crop_bwd": ("roi_crop_bwd_",),
                "bn_act": ("bn_act_fwd_kernel",),
                "bn_act_bwd": ("bn_act_bwd_kernel",)}


def kernel_launches(prof) -> Dict[str, int]:
    """The hand kernels' runs on the device in a profile, counted by
    their names (`KERNEL_NAMES`): also the runs of a CUDA graph's kernel
    nodes, which no wrapper counts."""
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {key: sum(any(f in n for f in funcs) for n in names)
            for key, funcs in KERNEL_NAMES.items()}


def profiled_pass(ev: Evaluator, batches, k: int, staged: bool) -> Dict:
    """One pass under torch.profiler, tracing the device only: the
    device's busy and idle share of the pass's host window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev.eval_split(batches, images_per_dispatch=k, stage_uploads=staged)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy(prof)
    return dict(busy, window_ms=window_ms,
                idle_share=1.0 - busy["busy_ms"] / window_ms)


def run_mode(ev: Evaluator, batches, k: int, staged: bool,
             passes: int, profiled: bool = True) -> Dict:
    """A mode's checked pass, timed passes (none: the checked pass is
    timed) and, if `profiled`, profiled pass (the extent crop as `ev`'s
    config sets it)."""
    checked = checked_pass(ev, batches, k, staged)
    valid = sum(int(np.sum(b["sent_valid"])) for b in batches)
    rates = [] if passes else [checked["seconds"]]
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev.eval_split(batches, images_per_dispatch=k, stage_uploads=staged)
        torch.cuda.synchronize()
        rates.append(time.perf_counter() - t0)
    expr = sorted(valid / t for t in rates)
    imgs = sorted(len(batches) / t for t in rates)
    return dict(checked, mode={"images_per_dispatch": k,
                               "extent_crop": ev.cfg.data.wire_extent_crop,
                               "staged": staged},
                expr_per_s={"best": expr[-1],
                            "median": statistics.median(expr),
                            "passes": expr},
                images_per_s={"best": imgs[-1],
                              "median": statistics.median(imgs),
                              "passes": imgs},
                profile=(profiled_pass(ev, batches, k, staged)
                         if profiled else None))


def mode_name(k, crop, staged) -> str:
    return (f"ipd{k}_crop{'on' if crop else 'off'}_"
            f"staged{'on' if staged else 'off'}")


def sentence_gaps(got: Dict, want: Dict):
    """How far a pass's sentences (`checked_pass`'s `sentences`) are from
    another's: (the keys either lacks, the largest box coordinate gap in
    pixels, the largest I gap, the largest U gap, the number of sentences
    whose box moved at all)."""
    keys = set(got) ^ set(want)
    gaps = [float(np.max(np.abs(np.subtract(got[q][0], want[q][0]))))
            for q in set(got) & set(want)]
    inter = max((abs(got[q][1] - want[q][1]) for q in set(got) & set(want)),
                default=0)
    union = max((abs(got[q][2] - want[q][2]) for q in set(got) & set(want)),
                default=0)
    return (sorted(keys), max(gaps, default=0.0), inter, union,
            sum(g > 0 for g in gaps))


def check_modes(results: Dict[str, Dict]) -> List[str]:
    """What the modes got wrong: a mode whose sentence count, det_correct
    or seg_correct differ from one image a dispatch with the crop off, or
    whose sentences do (each valid sentence of each image: its selected
    box by more than BOX_TOL pixels a coordinate, or its I
    or U pixel counts by more than 4, as bf16 convolutions over 4 images
    may round otherwise than over one); a crop-on pass whose state or
    sentences differ at all from the crop-off pass of its k and staging;
    a dispatch that did not launch NMS and the gate once; a host sync
    inside a dispatch."""
    wrong = []
    base_r = results[mode_name(1, False, True)]
    base = base_r["state"]
    for name, r in results.items():
        m = r["mode"]
        st = r["state"]
        if (st[0], st[1], st[4]) != (base[0], base[1], base[4]):
            wrong.append(f"{name}: counts {st} differ from {base}")
        keys, box, inter, union, moved = sentence_gaps(r["sentences"],
                                                       base_r["sentences"])
        r["sentence_gaps"] = {"box_px": box, "inter": inter, "union": union,
                              "boxes_moved": moved}
        if keys or len(r["sentences"]) != st[0] or box > BOX_TOL or \
                inter > 4 or union > 4:
            wrong.append(f"{name}: sentences differ from one image a "
                         f"dispatch with the crop off: keys {keys[:4]}, box "
                         f"{box} px, I {inter}, U {union}")
        if m["extent_crop"]:
            off = results[mode_name(m["images_per_dispatch"], False,
                                    m["staged"])]
            if st != off["state"] or r["sentences"] != off["sentences"]:
                wrong.append(f"{name}: state {st} or its sentences differ "
                             f"from the crop off's {off['state']}")
        if any(d[2:4] != (1, 1) for d in r["dispatches"]) or \
                tuple(r["launches"]) != (len(r["dispatches"]),) * 2:
            wrong.append(f"{name}: a dispatch did not launch NMS and the "
                         f"gate once: {[d[:4] for d in r['dispatches']]}")
        if r["host_syncs"]:
            wrong.append(f"{name}: host syncs inside a dispatch: "
                         f"{r['host_syncs'][:3]}")
    return wrong


def summary_line(name: str, r: Dict) -> str:
    spans = [(n, s, round(ms, 2)) for n, s, _, _, ms in r["dispatches"]]
    p = r["profile"]
    idle = ("idle not profiled" if p is None else
            f"idle {100 * p['idle_share']:.1f}% of a {p['window_ms']:.0f} "
            f"ms pass (busy {p['busy_ms']:.1f} ms, copies "
            f"{p['copy_ms']:.1f} ms)")
    return (f"[eval-modes] {name}: {r['expr_per_s']['best']:.1f} valid "
            f"expr/s (median {r['expr_per_s']['median']:.1f}), "
            f"{r['images_per_s']['best']:.2f} images/s; h2d "
            f"{r['h2d_bytes'] / 2 ** 20:.1f} MiB a pass; {idle}; peak "
            f"{r['peak_gib']:.2f} GiB; dispatches (images, S, device ms) "
            f"{spans}")


def run_modes(model, cfg: Config, batches, passes: int = 3,
              modes=MODES, profiled=MODES) -> Dict[str, Dict]:
    """Every mode of `modes` on `model` over `batches`, after a warm-up
    pass at 4 and at 1 image a dispatch, those of `profiled` with a pass
    under torch.profiler; raises if a mode got anything wrong
    (`check_modes`), with each mode's gaps to one image a dispatch with
    the crop off printed first."""
    warm = Evaluator(model, cfg)
    warm.eval_split(batches, images_per_dispatch=4)
    warm.eval_split(batches)
    results = {}
    for k, crop, staged in modes:
        name = mode_name(k, crop, staged)
        mcfg = copy.deepcopy(cfg)
        mcfg.data.wire_extent_crop = crop
        results[name] = run_mode(Evaluator(model, mcfg), batches, k, staged,
                                 passes, (k, crop, staged) in profiled)
        print(summary_line(name, results[name]), flush=True)
    wrong = check_modes(results)
    print("[eval-modes] largest gaps to one image a dispatch with the crop "
          "off, over every valid sentence: " + "; ".join(
              f"{name} {r['sentence_gaps']}" for name, r in results.items()),
          flush=True)
    if wrong:
        raise RuntimeError("profile_eval: " + "; ".join(wrong))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    cfg = eval_config()
    results = run_modes(build_model(cfg, device="cuda", seed=args.seed), cfg,
                        eval_mix(cfg), args.passes)
    print(json.dumps({"device": smi, "modes": results}))


if __name__ == "__main__":
    main()
