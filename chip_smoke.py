#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lang2seg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):
  1. environment: device, `nvidia-smi` name and power limit, TF32 flags
     (both set off, so f32 matmuls and convolutions run in full f32);
  2. build both CUDA kernels from lang2seg_tpu_torch/csrc with nvcc for
     sm_90a, in parallel;
  3. NMS kernel against its plain version on the card, bit for bit:
     (16, 6000) -> 300 and (16, 12000) -> 2000 on RPN draws, uniform
     boxes, a dense cluster, a spread grid and jittered twins, and the
     edge cases of `tools/profile_nms.py::edge_cases` (N = 63, 64, 65,
     129; max_out reached on a tile's last box and mid-tile; max_out > N;
     an all-invalid lane beside valid ones; 1, 4 and 8 lanes; a grid
     that fills a frontier of 2000); then its device time at both RPN
     shapes (`profile_nms.device_ms`), each beside its bound;
  4. fused gate kernel against its plain version on the card at its two
     main-path shapes (`tools/profile_gate.py::SHAPES`): (16, 40, 64,
     1024) bf16 through a stride-0 broadcast map (serving) and gathered
     from 2 images (training), K=7 sigmoid normalized and K=1 multiply:
     response within 1e-3 of max|response|, and within 1e-5 of it for
     these bf16 maps (the tensor-core product with the filter split in a
     hi and a lo bf16 part; a one-pass bf16 product misses this by far),
     gated within 1 bf16 ulp; then its device time at each shape beside
     its bound, the tile plan the wrapper launched it with and its
     registers (ptxas, build.log);
  4b. the gate's backward kernel against its plain version at the
     training shape, K=7 sigmoid normalized and K=1 multiply, given the
     same response: d_conv within 2 bf16 ulps (counted at no less than
     2^-8 of max|d_conv|), d_filt and d_rfilt within 1e-3 of their
     max|value|, and the same bits on a second call; then its time;
  5. the serving path at full width (ResNet-101-C4 `response` variant,
     random weights from a seed, 640x1024 canvas): 3 requests of 4, 8
     and 16 expressions through Inference.predict and
     Evaluator.eval_image, with the kernel launch counts set to 0 before
     and read after; every request must launch each kernel exactly once
     per forward;
  6. a small input (resnet26, 128x192, f32) served on the card and on
     the CPU (plain versions) from the same weights must agree;
  7. the training path at full width: `Trainer` over 2 images x 16
     expressions (uint8 canvases, bit-packed masks), random weights from
     a seed, at the config's LR: 1 warm-up step, 1 step under PyTorch's
     synchronisation debug mode (which must report no host sync inside
     `train_step`) and 3 timed steps, with the launch counts set to 0
     before and read after. Every step must launch the NMS, the gate and
     the gate's backward exactly once and give finite losses; frozen
     parameters stay bit-identical and every SGD group moves;
  8. one tiny f32 training step (resnet26, 128x192) on the card and on the
     CPU from the same weights, dropout draws and injected targets: the
     losses and the updates must agree.
Then one `{"kernels": [...]}` line (one NMS entry and one gate entry per
shape, its launches from the run of that shape's path: serving in phase
5, training in phase 7; the gate's backward's from training) and,
last, the `{"ok": true, ...}`
line. Details go to chiprun_out/chip_smoke.json. Exits non-zero without a
CUDA device or outside a checkout of the repository.
"""

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from lang2seg_tpu_torch.config import Config, apply_variant, flagship_config  # noqa: E402
from lang2seg_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_batch, synthetic_eval_request, to_wire)
from lang2seg_tpu_torch.engine.evaluator import Evaluator  # noqa: E402
from lang2seg_tpu_torch.engine.inference import Inference  # noqa: E402
from lang2seg_tpu_torch.engine.train_state import (  # noqa: E402
    create_train_state, to_device, train_step)
from lang2seg_tpu_torch.engine.trainer import Trainer  # noqa: E402
from lang2seg_tpu_torch.models.network import build_model  # noqa: E402
from lang2seg_tpu_torch.ops import _build, fused_filter, nms_cuda  # noqa: E402
from lang2seg_tpu_torch.ops.anchors import shifted_anchors  # noqa: E402
from lang2seg_tpu_torch.ops.fused_filter import (  # noqa: E402
    fused_dynamic_filter_bwd_plain, fused_dynamic_filter_plain)
from lang2seg_tpu_torch.ops.nms import nms_padded  # noqa: E402
from lang2seg_tpu_torch.ops.targets import (  # noqa: E402
    anchor_targets, proposal_targets)
from lang2seg_tpu_torch.tools.profile_gate import (  # noqa: E402
    SHAPES as GATE_SHAPES, bf16_ulp_distance, bf16_ulps_floored, gate_bound,
    gate_bwd_bound, gate_inputs, kernel_registers)
from lang2seg_tpu_torch.tools.profile_nms import (  # noqa: E402
    MAIN_SHAPES, device_ms, edge_cases, lane_stats, nms_bound, rpn_draw,
    time_ms)
from lang2seg_tpu_torch.utils.metrics import SegEvalAccumulator  # noqa: E402
from lang2seg_tpu_torch.weights import init_params  # noqa: E402

OUT = os.path.join(REPO, "chiprun_out")
record = {}


def log(*a):
    print(*a, flush=True)


def check(ok, what="check failed"):
    """A failed check ends the run (an exception, also under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


# ---------------------------------------------------------------- phase 1

def environment():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.cuda.get_device_name(0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {dev} count {torch.cuda.device_count()}")
    log(f"[env] tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    log(smi)
    record["env"] = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "device": dev, "nvidia_smi": smi}
    return smi


# ---------------------------------------------------------------- phase 2

def build():
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[build] {sorted(paths)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: { {k: round(v, 1) for k, v in _build.build_seconds.items()} })")
    for name, path in paths.items():
        logf = path.with_name("build.log")
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
    record["build_seconds"] = dict(_build.build_seconds)


# ---------------------------------------------------------------- phase 3

def nms_cases(dev):
    g = np.random.RandomState(0)

    def rand(e, n, lim=100.0):
        xy = g.uniform(0, lim, (e, n, 2))
        wh = g.uniform(5, lim / 2, (e, n, 2))
        return torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                                .astype(np.float32)).to(dev)

    base = np.array([10.0, 10.0, 60.0, 60.0])
    cluster = base + g.uniform(-8, 8, (2, 1024, 4))
    cluster[..., 2:] = np.maximum(cluster[..., 2:], cluster[..., :2] + 1)
    xs, ys = np.meshgrid(np.arange(32) * 20.0, np.arange(16) * 20.0)
    grid = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 12,
                     ys.ravel() + 12], 1)[None].astype(np.float32)
    twins = np.empty((1, 1024, 4), np.float32)
    twins[:, 0::2] = grid
    twins[:, 1::2] = grid + g.uniform(-2, 2, grid.shape)
    part = rand(3, 700)
    pvalid = torch.ones((3, 700), dtype=torch.bool, device=dev)
    pvalid[:, 500:] = False
    pvalid[1, ::7] = False
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    ones = lambda b: torch.ones(b.shape[:2], dtype=torch.bool, device=dev)  # noqa: E731
    main = [(name, rpn_draw(e, n, seed, dev), None, thr, max_out)
            for name, e, n, seed, thr, max_out in MAIN_SHAPES]
    return main[:1] + [
        ("uniform_4x2048_512", rand(4, 2048), None, 0.7, 512),
        ("dense_cluster_2x1024_256", t(cluster), None, 0.5, 256),
        ("spread_grid_1x512_256", t(grid), None, 0.5, 256),
        ("twins_1x1024_256", t(twins), None, 0.5, 256),
        ("partial_valid_3x700_128", part, pvalid, 0.7, 128),
    ] + main[1:] + [(name, t(b), torch.from_numpy(v).to(dev), thr, max_out)
                    for name, b, v, thr, max_out in edge_cases()], ones


def check_nms(dev):
    """The kernel bit for bit against its plain version on every case;
    then its time at the main path's two shapes, each with its bound."""
    cases, ones = nms_cases(dev)
    main = {}
    max_err = 0.0          # largest |kernel - plain| over every case and slot
    for name, boxes, valid, thr, max_out in cases:
        valid = ones(boxes) if valid is None else valid
        ki, km = nms_cuda.nms_batched(boxes, valid, thr, max_out)
        pi, pm = nms_padded(boxes, valid, thr, max_out)
        torch.cuda.synchronize()
        same = torch.equal(ki, pi) and torch.equal(km, pm)
        max_err = max(max_err, float((ki - pi).abs().max()),
                      float((km != pm).sum()))
        kept, last = lane_stats(ki, km, boxes.shape[1], max_out)
        log(f"[nms] {name}: bit-identical={same} kept/lane={kept} "
            f"last examined/lane={last}")
        check(same, f"NMS kernel differs from its plain version on {name}")
        main[name] = (boxes, valid, thr, max_out, ki, km)
    results = []
    for (name, e, n, _, _, max_out), path in zip(MAIN_SHAPES,
                                                 ("serve", "train")):
        boxes, valid, thr, _, ki, km = main[name]
        call = (lambda: nms_cuda.nms_batched(boxes, valid, thr, max_out))
        # the kernel's device time: at the serving shape back-to-back calls
        # are bound by the host's wrapper, which events alone would time
        ms = device_ms(call, 50)
        events_ms = time_ms(call, 50)
        plain_ms = time_ms(lambda: nms_padded(boxes, valid, thr, max_out), 2)
        bound, by, byts, ops = nms_bound(ki, km, n, max_out)
        res = {"name": f"nms_{e}x{n}_{max_out}", "route": "cuda",
               "source": "lang2seg_tpu_torch/csrc/nms.cu",
               "replaces": "lang2seg_tpu/ops/nms_pallas.py:196",
               "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": None,
               "launched_by": ((path, "nms"),)}
        csize = nms_cuda.cluster_size(dev, e, n, max_out)
        log(f"[nms] ({e}, {n})->{max_out}: kernel {ms:.4f} ms device time "
            f"({csize} CTAs a lane; back-to-back calls {events_ms:.4f} ms), "
            f"plain {plain_ms:.2f} ms, bound {bound * 1e3:.3f} us ({by}: "
            f"{byts} B, {ops} ops)")
        record[res["name"]] = dict(res, bytes=byts, ops=ops,
                                   events_ms=events_ms, cluster_size=csize)
        results.append(res)
    return results


# ---------------------------------------------------------------- phase 4

def gate_registers():
    """Registers a thread of the main path's gate kernels (bf16, K=7,
    sigmoid, C=1024), as ptxas reported them in build.log."""
    regs = kernel_registers(_build.library_path("fused_filter").with_name(
        "build.log"))
    want = {"forward": "fused_filter_mma_kernel<7, 1024, true>",
            "backward": "fused_filter_bwd_kernel<__nv_bfloat16, 7, 256, true>"}
    out = {}
    for kind, key in want.items():
        hits = [v for name, v in regs.items() if key in name]
        check(len(hits) == 1, f"no ptxas line for {key}")
        r, frame, st, ld = hits[0]
        out[kind] = {"registers": r, "stack_bytes": frame,
                     "spill_bytes": st + ld}
    return out


def check_gate(dev, regs):
    """The forward against its plain version at its two main-path shapes,
    the map a stride-0 broadcast (serving) and gathered from 2 images
    (training): K=7 sigmoid normalized and K=1 multiply, response within
    1e-3 of max|response| and, these maps being bf16, within 1e-5 (the
    split filter's precision), gated within 1 bf16 ulp given the kernel's
    own response; then its time at each shape, each beside its bound."""
    results = []
    for (name, e, h, w, c, _, _, _, maps), path in zip(GATE_SHAPES,
                                                       ("serve", "train")):
        nmaps = 1 if maps == "broadcast" else e
        for seed, (k, gate, norm) in enumerate(((7, "sigmoid", True),
                                                (1, "multiply", False))):
            conv, filt, rfilt, _, _ = gate_inputs(e, h, w, c, k, maps, dev,
                                                  seed=seed)
            if k == 1:
                filt = filt * 0.03                   # keep |resp| ~ 1
            gk, rk = fused_filter.fused_dynamic_filter(conv, filt, rfilt, k,
                                                       gate, norm)
            gp, rp = fused_dynamic_filter_plain(conv, filt, rfilt, k, gate,
                                                norm)
            torch.cuda.synchronize()
            resp_err = float((rk - rp).abs().max())
            resp_tol = 1e-3 * float(rp.abs().max())
            resp_split_tol = 1e-5 * float(rp.abs().max())
            ulps = int(bf16_ulp_distance(gk.float(), gp.float()).max())
            gated_err = float((gk.float() - gp.float()).abs().max())
            # the gate given the kernel's own response: one rounding of the
            # f32 product, so within 1 bf16 ulp. Against the plain version's
            # gated map the response's f32 difference also enters: through a
            # sigmoid it stays within 1 ulp; the multiply gate passes it on
            # unbounded near resp = 0, where gated ~ 0 and an ulp is tiny
            g_k = torch.sigmoid(rk) if gate == "sigmoid" else rk
            same_g = (conv.float() * g_k).to(torch.bfloat16)
            ulps_given_resp = int(bf16_ulp_distance(gk.float(),
                                                    same_g.float()).max())
            log(f"[gate] {path} {maps} map K={k} {gate} normalize={norm}: "
                f"resp max err {resp_err:.3e} (tol {resp_tol:.3e}, split-filter "
                f"tol {resp_split_tol:.3e}); gated vs "
                f"plain: max {ulps} bf16 ulp, max abs {gated_err:.3e}; gated "
                f"vs plain gate on the kernel's response: max "
                f"{ulps_given_resp} bf16 ulp")
            check(resp_err <= resp_tol, "gate kernel response out of tolerance")
            check(resp_err <= resp_split_tol, "gate kernel response beyond "
                  "1e-5 of max: not the hi + lo split-filter product")
            check(ulps_given_resp <= 1, "gate kernel gated map beyond 1 bf16 ulp")
            if gate == "sigmoid":
                check(ulps <= 1, "gate kernel gated map beyond 1 bf16 ulp")
            check(gk.shape == (e, h, w, c) and rk.shape == (e, h, w, 1))
            if k == 7:                               # the main path's gate
                args = (conv, filt, rfilt, k, gate, norm)
                max_err, resp7_err = gated_err, resp_err
        call = (lambda a=args: fused_filter.fused_dynamic_filter(*a))
        ms = device_ms(call, 50)
        events_ms = time_ms(call, 50)
        plan = fused_filter.plans["forward"]     # as the timed calls ran
        check(plan["grid"][1] == e, "gate forward plan of another shape")
        plain_ms = time_ms(lambda a=args: fused_dynamic_filter_plain(*a), 5)
        bound, by, byts, ops = gate_bound(e, h, w, c, 7, 2, nmaps)
        res = {"name": f"fused_filter_{path}", "route": "cuda",
               "source": "lang2seg_tpu_torch/csrc/fused_filter.cu",
               "replaces": "lang2seg_tpu/ops/pallas_kernels.py:85",
               "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": None,
               "tile_plan": {"grid": plan["grid"],
                             "tile_pixels": plan["tile_pixels"],
                             "tiles_per_block": plan["tiles_per_block"]},
               "registers": regs["forward"]["registers"],
               "launched_by": ((path, "fused_filter"),)}
        log(f"[gate] {name} ({maps} map) bf16 K=7: kernel {ms:.4f} ms device "
            f"time (back-to-back calls {events_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound * 1e3:.2f} us ({by}: {byts} B, "
            f"{ops} ops); plan {res['tile_plan']}, {regs['forward']}")
        record[res["name"]] = dict(res, bytes=byts, ops=ops,
                                   events_ms=events_ms,
                                   resp_max_abs_err=resp7_err)
        results.append(res)
    return results


# --------------------------------------------------------------- phase 4b

def check_gate_bwd(dev, regs):
    name, e, h, w, c, _, _, _, maps = GATE_SHAPES[1]         # as trained
    out = None
    for seed, (k, gate, norm) in enumerate(((7, "sigmoid", True),
                                            (1, "multiply", False))):
        conv, filt, rfilt, d_gated, d_resp = gate_inputs(
            e, h, w, c, k, maps, dev, seed=10 + seed)
        if k == 1:
            filt = filt * 0.03
        _, fused = fused_filter.fused_dynamic_filter(conv, filt, rfilt, k,
                                                     gate, norm)
        args = (conv, filt, rfilt, fused, d_gated, d_resp, k, gate, norm)
        got = fused_filter.fused_dynamic_filter_bwd(*args)
        want = fused_dynamic_filter_bwd_plain(*args)
        again = fused_filter.fused_dynamic_filter_bwd(*args)
        torch.cuda.synchronize()
        ulps = bf16_ulps_floored(got[0], want[0])
        raw_ulps = int(bf16_ulp_distance(got[0].float(),
                                         want[0].float()).max())
        dconv_err = float((got[0].float() - want[0].float()).abs().max())
        errs = [float((a - b).abs().max()) for a, b in zip(got[1:], want[1:])]
        tols = [1e-3 * float(b.abs().max()) for b in want[1:]]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"[gate-bwd] K={k} {gate} normalize={norm}: d_conv {ulps:.2f} "
            f"bf16 ulp (floored; raw max {raw_ulps}), max abs {dconv_err:.3e};"
            f" d_filt err {errs[0]:.3e} (tol {tols[0]:.3e}); d_rfilt err "
            f"{errs[1]:.3e} (tol {tols[1]:.3e}); repeatable={same}")
        check(ulps <= 2.0, "gate backward d_conv beyond 2 bf16 ulps")
        check(errs[0] <= tols[0], "gate backward d_filt out of tolerance")
        check(errs[1] <= tols[1], "gate backward d_rfilt out of tolerance")
        check(same, "gate backward not repeatable")
        check(got[0].dtype == torch.bfloat16 and got[0].shape == conv.shape)
        if k == 7:
            out = (args, dconv_err, errs)
    args, dconv_err, errs = out
    call = (lambda: fused_filter.fused_dynamic_filter_bwd(*args))
    ms = device_ms(call, 50)
    events_ms = time_ms(call, 50)
    plan = fused_filter.plans["backward"]        # as the timed calls ran
    plain_ms = time_ms(lambda: fused_dynamic_filter_bwd_plain(*args), 5)
    bound, by, byts, ops = gate_bwd_bound(e, h, w, c, 7, 2, e)
    res = {"name": "fused_filter_bwd", "route": "cuda",
           "source": "lang2seg_tpu_torch/csrc/fused_filter.cu",
           "replaces": "lang2seg_tpu/ops/pallas_kernels.py:147",
           "max_abs_err": max([dconv_err] + errs), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": None,
           "tile_plan": {"grid": plan["grid"],
                         "tile_pixels": plan["tile_pixels"],
                         "tiles_per_block": plan["tiles_per_block"]},
           "registers": regs["backward"]["registers"],
           "launched_by": (("train", "fused_filter_bwd"),)}
    log(f"[gate-bwd] {name} (gathered map) bf16 K=7: kernel {ms:.4f} ms "
        f"device time (back-to-back calls {events_ms:.4f} ms), plain "
        f"{plain_ms:.3f} ms, bound {bound * 1e3:.2f} us ({by}: {byts} B, "
        f"{ops} ops); plan {res['tile_plan']}, {regs['backward']}")
    record["fused_filter_bwd"] = dict(res, bytes=byts, ops=ops,
                                      events_ms=events_ms,
                                      d_filt_err=errs[0], d_rfilt_err=errs[1])
    return res


# ---------------------------------------------------------------- phase 5

def serve_full_width():
    cfg = flagship_config()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[serve] flagship response model built in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.state_dict().values())} weights)")
    inf = Inference(model, cfg)
    ev = Evaluator(model, cfg)
    # COCO images are <= 640 a side; scaled by 1.6 they fill the canvas
    scale = 1.6
    sizes = ((4, 1), (8, 2), (16, 3))
    # warm-up at every request size: cuDNN picks its algorithms and the
    # allocator grows on the first call of each shape
    for num_expr, seed in sizes:
        ev.eval_image(synthetic_eval_request(cfg, num_expr, 100 + seed, scale),
                      SegEvalAccumulator())
    torch.cuda.synchronize()

    acc = SegEvalAccumulator()
    timings = []
    torch.cuda.reset_peak_memory_stats()
    nms_cuda.launches = 0
    fused_filter.launches = 0
    for num_expr, seed in sizes:
        b = synthetic_eval_request(cfg, num_expr, seed, scale)
        n0, f0 = nms_cuda.launches, fused_filter.launches
        t0 = time.perf_counter()
        out = inf.predict(b["images"], b["im_hw"], b["labels"])
        torch.cuda.synchronize()
        t_pred = (time.perf_counter() - t0) * 1e3
        check((nms_cuda.launches - n0, fused_filter.launches - f0) == (1, 1))
        r = cfg.test.rpn_post_nms_top_n
        shapes = {"rois": (num_expr, r, 4), "roi_valid": (num_expr, r),
                  "cls_prob": (num_expr, r, 81),
                  "bbox_pred": (num_expr, r, 324),
                  "gated_conv": (num_expr, 40, 64, 1024),
                  "response": (num_expr, 40, 64, 1)}
        for k, shp in shapes.items():
            check(tuple(out[k].shape) == shp, (k, tuple(out[k].shape)))
            if k != "roi_valid":
                check(bool(torch.isfinite(out[k].float()).all()), k)
        check(out["gated_conv"].dtype == torch.bfloat16)
        check(bool(out["roi_valid"].any(1).all()))
        masks = inf.boxes_to_masks(out["gated_conv"], out["rois"][:, :2],
                                   torch.ones((num_expr, 2), dtype=torch.int64))
        check(masks.shape == (num_expr, 2, 14, 14))
        check(bool(((masks >= 0) & (masks <= 1)).all()))

        n0, f0 = nms_cuda.launches, fused_filter.launches
        t0 = time.perf_counter()
        ev.eval_image(b, acc)
        torch.cuda.synchronize()
        t_eval = (time.perf_counter() - t0) * 1e3
        check((nms_cuda.launches - n0, fused_filter.launches - f0) == (1, 1))
        timings.append({"expressions": num_expr, "predict_ms": t_pred,
                        "eval_image_ms": t_eval})
        log(f"[serve] request E={num_expr}: predict {t_pred:.1f} ms, "
            f"eval_image {t_eval:.1f} ms")
    launches = {"nms": nms_cuda.launches,
                "fused_filter": fused_filter.launches}
    summary = acc.summary()
    check(acc.num_sent == 28 and acc.seg_total == 28)
    for k, v in summary.items():
        check(0.0 <= float(v) <= 1.0, (k, v))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[serve] main-path launches {launches}; metrics "
        f"{ {k: round(float(v), 4) for k, v in summary.items()} }; "
        f"peak device memory {peak:.2f} GiB")
    check(launches["nms"] > 0 and launches["fused_filter"] > 0)
    record["serve"] = {"timings": timings, "launches": launches,
                       "metrics": {k: float(v) for k, v in summary.items()},
                       "peak_gib": peak}
    return launches


# ---------------------------------------------------------------- phase 6

def small_reference():
    """The tiny f32 config served on the card (kernels) and on the CPU
    (plain versions) from the same weights. The RPN class weights are
    scaled by 100, as in tests/test_torch_slice.py, so that near-tied
    objectness scores at random init do not reorder between devices."""
    cfg = apply_variant(Config(), "response")
    cfg.data.canvas_h, cfg.data.canvas_w = 128, 192
    cfg.model.backbone = "resnet26"
    cfg.model.vocab_size = 100
    cfg.model.compute_dtype = "float32"
    cfg.model.normalize_response = True
    cfg.test.rpn_pre_nms_top_n, cfg.test.rpn_post_nms_top_n = 256, 32
    sd = init_params(cfg, 7)
    for k in ("rpn_cls_score_net.weight", "rpn_cls_score_net.bias"):
        sd[k] = sd[k] * 100.0
    b = synthetic_eval_request(cfg, 3, 5)
    outs, accs = {}, {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev, state_dict=sd)
        outs[dev] = {k: v.float().cpu() for k, v in Inference(
            model, cfg, device=dev).predict(b["images"], b["im_hw"],
                                            b["labels"]).items()}
        accs[dev] = SegEvalAccumulator()
        Evaluator(model, cfg, device=dev).eval_image(b, accs[dev])
    a, p = outs["cuda"], outs["cpu"]
    check(torch.equal(a["roi_valid"], p["roi_valid"]))
    errs = {k: float((a[k] - p[k]).abs().max()) for k in a}
    log(f"[reference] card vs CPU, tiny f32 config: max abs diff {errs}")
    check(errs["rois"] <= 1e-2)
    for k in ("cls_prob", "cls_score", "bbox_pred", "response", "gated_conv"):
        check(errs[k] <= 1e-3, k)
    check(accs["cuda"].det_correct == accs["cpu"].det_correct)
    check(abs(accs["cuda"].cum_i - accs["cpu"].cum_i) <= 4)
    record["reference"] = errs


# ---------------------------------------------------------------- phase 7

def launch_counts():
    return (nms_cuda.launches, fused_filter.launches,
            fused_filter.bwd_launches)


def train_full_width():
    cfg = flagship_config()
    num_images, num_expr = 2, 16
    batches = [to_wire(cfg, synthetic_batch(cfg, num_images, num_expr,
                                            seed=s)) for s in range(4)]
    t0 = time.perf_counter()
    trainer = Trainer(cfg, batches, device="cuda", seed=0)
    model = trainer.state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    log(f"[train] flagship response model and SGD built in "
        f"{time.perf_counter() - t0:.1f} s; lr {cfg.train.learning_rate}, "
        f"{len(trainer.state.optimizer.param_groups)} groups")

    nms_cuda.launches = fused_filter.launches = fused_filter.bwd_launches = 0
    t0 = time.perf_counter()
    steps = [trainer.train(1)]                          # warm-up
    torch.cuda.synchronize()
    log(f"[train] warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms")
    per_step = [launch_counts()]
    # one step with PyTorch's CUDA synchronisation debug mode on: any host
    # synchronisation inside train_step is reported as a warning (the
    # batch is uploaded before it, the losses read after it)
    batch = to_device(batches[1], "cuda")
    c0 = launch_counts()

    def host_syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            out = fn()
            torch.cuda.set_sync_debug_mode("default")
        return out, [str(x.message) for x in caught if
                     "called a synchronizing CUDA operation" in str(x.message)]

    losses, syncs = host_syncs(
        lambda: train_step(trainer.state, batch, trainer.generator))
    # control: reading a loss is a host sync, and the mode must report it
    _, control = host_syncs(lambda: float(losses["total_loss"]))
    log(f"[train] step 2 under the sync debug mode: {len(syncs)} host "
        f"synchronisations {syncs[:3]} (control, a loss read: "
        f"{len(control)})")
    check(control, "the sync debug mode did not report a loss read")
    check(not syncs, "the train step synchronises with the host")
    steps.append({k: float(v) for k, v in losses.items()})
    per_step.append(tuple(b - a for a, b in zip(c0, launch_counts())))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3, 6):
        c0 = launch_counts()
        t0 = time.perf_counter()
        steps.append(trainer.train(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(b - a for a, b in zip(c0, launch_counts())))
    launches = dict(zip(("nms", "fused_filter", "fused_filter_bwd"),
                        launch_counts()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] step ms {[round(t, 2) for t in times]} (mean "
        f"{sum(times) / len(times):.2f}); peak device memory {peak:.2f} GiB; "
        f"launches per step (nms, gate, gate bwd) {per_step}")
    for i, ls in enumerate(steps):
        log(f"[train] step {i + 1} losses "
            f"{ {k: round(v, 4) for k, v in sorted(ls.items())} }")
        check(all(np.isfinite(v) for v in ls.values()),
              f"non-finite loss at step {i + 1}")
    check(all(c == (1, 1, 1) for c in per_step),
          "a train step did not launch each kernel exactly once")
    check(trainer.state.step == 5)
    after = dict(model.named_parameters())
    frozen = [n for n, p in after.items() if not p.requires_grad]
    check(frozen and all(torch.equal(before[n], after[n]) for n in frozen),
          "a frozen parameter changed")
    moved = {}
    for grp in trainer.state.optimizer.param_groups:
        n_moved = sum(int(not torch.equal(before[n], p))
                      for n, p in zip(grp["names"], grp["params"]))
        moved[f"x{grp['lr_mult']:g} wd {grp['weight_decay']:g}"] = \
            f"{n_moved}/{len(grp['params'])}"
        check(n_moved > 0, f"SGD group {grp['lr_mult']} did not move")
    log(f"[train] {len(frozen)} frozen parameters bit-identical; moved per "
        f"group {moved}")
    record["train"] = {"step_ms": times, "peak_gib": peak,
                       "lr": cfg.train.learning_rate, "launches": launches,
                       "launches_per_step": per_step, "losses": steps,
                       "moved_per_group": moved, "host_syncs": len(syncs)}
    return launches


# ---------------------------------------------------------------- phase 8

def small_train_reference():
    """One tiny f32 SGD step on the card (kernels) and on the CPU (plain
    versions) from the same weights, the same word-dropout draws (a CPU
    generator feeds both) and the same injected targets. The LR is 1, so
    that the updates stand far above the parameters' own f32 rounding."""
    cfg = apply_variant(Config(), "response")
    cfg.data.canvas_h, cfg.data.canvas_w = 128, 192
    cfg.model.backbone = "resnet26"
    cfg.model.vocab_size = 100
    cfg.model.compute_dtype = "float32"
    cfg.model.normalize_response = True
    cfg.train.grad_clip_norm = 10.0
    cfg.train.learning_rate = 1.0
    cfg.train.roi_batch_size = 32
    sd = init_params(cfg, 7)
    batch = to_wire(cfg, synthetic_batch(cfg, 2, 4, seed=5))
    g = torch.Generator().manual_seed(6)
    e = 4
    gt = torch.from_numpy(batch["gt_boxes"])[:, None]
    valid = torch.ones((e, 1), dtype=torch.bool)
    im_hw = torch.from_numpy(batch["im_hw"][batch["img_idx"]])
    anchors = shifted_anchors(8, 12, 16, cfg.model.anchor_scales,
                              cfg.model.anchor_ratios)
    at = anchor_targets(anchors, gt, valid, im_hw[:, 0], im_hw[:, 1],
                        generator=g)
    rois = gt[:, :, :4] + torch.randn((e, 64, 4), generator=g) * 6.0
    rois = torch.clamp(rois, min=0.0)
    rois[..., 2:] = torch.maximum(rois[..., 2:], rois[..., :2] + 4.0)
    masks = np.unpackbits(batch["gt_masks"], axis=-1)[:, None]
    pt = proposal_targets(rois, torch.ones((e, 64), dtype=torch.bool), gt,
                          valid, torch.from_numpy(masks), generator=g,
                          num_rois=32)
    out = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(cfg, device=dev, state_dict=sd)
        old = {k: v.detach().float().cpu().clone()
               for k, v in state.model.state_dict().items()}
        c0 = launch_counts()
        targets = tuple(type(t)(*(x.to(dev) for x in t)) for t in (at, pt))
        losses = train_step(state, to_device(batch, dev),
                            torch.Generator().manual_seed(0), targets)
        if dev == "cuda":
            torch.cuda.synchronize()
            check(tuple(b - a for a, b in zip(c0, launch_counts()))
                  == (0, 1, 1), "the tiny step did not launch both gate "
                  "kernels once")
        new = {k: v.detach().float().cpu()
               for k, v in state.model.state_dict().items()}
        out[dev] = ({k: float(v) for k, v in losses.items()},
                    {k: new[k] - old[k] for k in new})
    (lc, dc), (lp, dp) = out["cuda"], out["cpu"]
    loss_err = {k: abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    upd_err = {k: float((dc[k] - dp[k]).norm() / dp[k].norm())
               for k in dp if float(dp[k].norm()) > 0}
    frozen_moved = [k for k in dp if float(dp[k].norm()) == 0
                    and float(dc[k].norm()) > 0]
    worst = max(upd_err, key=upd_err.get)
    log(f"[train-reference] card vs CPU, tiny f32 step: loss rel err max "
        f"{max(loss_err.values()):.2e}; update rel L2 err max "
        f"{upd_err[worst]:.2e} ({worst}) over {len(upd_err)} tensors")
    check(max(loss_err.values()) <= 1e-4, ("losses", loss_err))
    check(upd_err[worst] <= 1e-3, ("updates", worst, upd_err[worst]))
    check(not frozen_moved and len(upd_err) >= 40, frozen_moved)
    record["train_reference"] = {"loss_rel_err": loss_err,
                                 "update_rel_err_max": upd_err[worst],
                                 "worst": worst}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    environment()
    build()
    dev = torch.device("cuda")
    regs = gate_registers()
    kernels = check_nms(dev) + check_gate(dev, regs) + [
        check_gate_bwd(dev, regs)]
    runs = {"serve": serve_full_width()}
    small_reference()
    runs["train"] = train_full_width()
    small_train_reference()
    for kr in kernels:
        kr["launches"] = sum(runs[path].get(counter, 0)
                             for path, counter in kr["launched_by"])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "tile_plan", "registers")
    kernels = [{k: kr[k] for k in keys if k in kr} for kr in kernels]
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - t_start
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"[done] {record['seconds']:.1f} s")
    log(record["env"]["nvidia_smi"])
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
