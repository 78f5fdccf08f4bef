"""Where a training step's time goes on the card.

    python -m lang2seg_tpu_torch.tools.profile_train [--expressions 16]
        [--variant response]

Builds the `variant` preset for training at full width
(`config.flagship_config(variant)`: random weights from a seed, the
config's SGD groups, 2 images per step as the JAX bench runs it), takes
two warm-up steps, then times one step in three stages with CUDA events
(`train_forward` with its losses, the backward, clipping and the SGD
update). With the caption loss (`cycle`, `cycle_response`) the caption
branch is then timed alone on that step's own inputs, in four stages:
layer4 on both full maps with the pools, the captioner's teacher-forced
loop, its backward, and the backward through layer4. With VGG16 (`vgg`)
its tail, fc6 and fc7, is timed alone forward and backward on the step's
number of ROI crops. It profiles one more step with `torch.profiler`:
the device's busy time against the host window, the
time of the port's hand kernels (NMS, the gate and its backward, the ROI
crop and its backward), and the twelve largest
device-time entries. A last step records its NMS input: per lane the
boxes kept and the last box examined, the kernel's device time alone on
that input and its cycles a tile by phase (`profile_nms.phase_cycles`);
and its ROI crop's, the training crop's maps, sample coordinates and
gradient: the ROIs' extents in cells and the map rows each reaches
(`profile_crop.roi_reach`), the two crop kernels checked on that input
against their plain versions (the same bits) and timed alone, and with
`--baseline PATH` (an earlier roi_crop.cu) that source's kernels timed
beside them in turns (`profile_crop.side_by_side`).
Prints one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..config import flagship_config
from ..data.synthetic import synthetic_batch, to_wire
from ..engine.train_state import (apply_update, create_train_state,
                                  to_device, train_step)
from ..ops import nms_cuda, proposals, roi_crop_cuda
from ..ops.roi_align import crop_bwd_coords_plain, crop_gather_plain
from .profile_crop import _baseline, roi_reach, side_by_side
from .profile_nms import device_ms, lane_stats, phase_cycles

# the port's own kernels, by the names nvcc gives them
HAND_KERNELS = ("nms_", "fused_filter_mma_kernel", "fused_filter_bwd_",
                "roi_crop_fwd_kernel", "roi_crop_bwd_kernel",
                "bn_act_fwd_kernel", "bn_act_bwd_kernel")


def staged_step(state, batch, generator):
    """One `train_step`, its three stages timed with CUDA events."""
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark("start")
    state.optimizer.zero_grad(set_to_none=True)
    losses = state.model.train_forward(batch, None, generator)
    mark("forward_and_losses")
    losses["total_loss"].backward()
    mark("backward")
    apply_update(state)
    mark("sgd")
    torch.cuda.synchronize()
    return {name: a.elapsed_time(b)
            for (_, a), (name, b) in zip(marks, marks[1:])}


def caption_stages(model, batch, generator):
    """The caption branch of `train_forward` alone, on a step's inputs
    (the gathered C4 map and the gate's output, computed first without a
    graph), its four stages timed with CUDA events."""
    with torch.no_grad():
        images = model._images(batch["images"])
        net_conv = model.backbone.head(images).index_select(
            0, batch["img_idx"].long())
        gated, _ = model._condition(net_conv, batch["labels"], generator)
        gt_masks = model._gt_masks(batch["gt_masks"], images.shape[2])
    net_conv.requires_grad_(True)
    gated.requires_grad_(True)
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark("start")
    feats_b = (gated if model.cfg.model.response_gate == "sigmoid"
               else model.gt_masked_map(net_conv, gt_masks))
    fc, att = model.caption_features(net_conv, feats_b)
    mark("caption_tail_forward")
    fc_in = fc.detach().requires_grad_(True)
    att_in = att.detach().requires_grad_(True)
    nll = model.caption_model.teacher_forced_nll(
        fc_in, att_in, batch["cap_labels"], batch["cap_masks"], generator)
    mark("captioner_forward")
    nll.backward()
    mark("captioner_backward")
    # att2in2 never reads its fc features: only att carries a gradient
    torch.autograd.backward(att, att_in.grad)
    mark("caption_tail_backward")
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    return {name: a.elapsed_time(b)
            for (_, a), (name, b) in zip(marks, marks[1:])}


def vgg_tail_stages(model, rois, generator):
    """VGG16's tail (fc6 and fc7 in f32, with their dropout) alone on a
    step's number of ROI crops (rois x 7 x 7 x 512 of the compute dtype),
    forward and backward timed with CUDA events: fc6's share of the
    step."""
    crops = torch.randn((rois, 7, 7, 512), device="cuda").to(
        model.compute_dtype).requires_grad_(True)
    times = {}
    for _ in range(2):                            # the first is a warm-up
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        a.record()
        out = model.vgg.tail(crops, generator)
        b.record()
        out.sum().backward()
        c.record()
        torch.cuda.synchronize()
        times = {"vgg_tail_forward": a.elapsed_time(b),
                 "vgg_tail_backward": b.elapsed_time(c)}
    model.zero_grad(set_to_none=True)
    return times


def step_crop(fwd_calls, bwd_calls, baseline=None):
    """The crop of a step's largest crop backward, from the recorded
    wrapper calls (the forward's (feat, ys, xs), the backward's (grad, ys,
    xs, h, w)): its shape, the ROIs' extents (`roi_reach`), both kernels
    checked against their plain versions (the same bits) and timed alone
    on it, and beside an earlier roi_crop.cu's kernels when `baseline`
    names one."""
    grad, ys, xs, h, w = max(bwd_calls, key=lambda a: a[0].numel())
    feat, = [f.detach() for f, fy, _ in fwd_calls
             if fy.data_ptr() == ys.data_ptr() and fy.shape == ys.shape]
    out = {"shape": list(grad.shape), "map": list(feat.shape),
           "dtype": str(grad.dtype).split(".")[-1],
           **roi_reach(ys, xs, h),
           "fwd_gather_equal": bool(torch.equal(
               roi_crop_cuda.launch_forward(feat, ys, xs),
               crop_gather_plain(feat, ys, xs))),
           "bwd_plain_equal": bool(torch.equal(
               roi_crop_cuda.launch_backward(grad, ys, xs, h, w),
               crop_bwd_coords_plain(grad, ys, xs, h, w))),
           "fwd_ms": device_ms(lambda: roi_crop_cuda.launch_forward(
               feat, ys, xs), 20),
           "bwd_ms": device_ms(lambda: roi_crop_cuda.launch_backward(
               grad, ys, xs, h, w), 20)}
    if baseline:
        out["baseline"] = side_by_side(_baseline(baseline), feat, ys, xs,
                                       grad)
    return out


def _device_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--expressions", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variant", default="response")
    ap.add_argument("--baseline", default=None,
                    help="an earlier roi_crop.cu to time beside this one on "
                         "the step's crop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cfg = flagship_config(args.variant)
    state = create_train_state(cfg, device="cuda", seed=args.seed)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    batches = [to_device(to_wire(cfg, synthetic_batch(
        cfg, 2, args.expressions, seed=s)), "cuda")
        for s in range(5)]
    for b in batches[:2]:
        train_step(state, b, gen)
    stages = staged_step(state, batches[2], gen)
    total = sum(stages.values())
    for k, v in stages.items():
        print(f"[stage] {k:20s} {v:9.3f} ms  {100 * v / total:5.1f}%")
    caption = {}
    if cfg.model.use_caption_loss:
        caption_stages(state.model, batches[2], gen)      # warm-up
        caption = caption_stages(state.model, batches[2], gen)
        for k, v in caption.items():
            print(f"[caption] {k:22s} {v:9.3f} ms")
    tail = {}
    if cfg.model.backbone == "vgg16":
        tail = vgg_tail_stages(state.model, args.expressions
                               * cfg.train.roi_batch_size, gen)
        for k, v in tail.items():
            print(f"[vgg-tail] {k:22s} {v:9.3f} ms")
    torch.cuda.reset_peak_memory_stats()
    train_step(state, batches[2], gen)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[memory] peak {peak_gib:.2f} GiB in a step")

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batches[3], gen)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # busy time: the device time of the kernel entries themselves (one
    # stream, so they do not overlap), as the profiler table's total counts
    # it; the aten ops that launch them carry the same time again
    avgs = prof.key_averages()
    kernels = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    hand = {tag: sum(_device_us(e) for e in kernels if tag in e.key) / 1e3
            for tag in HAND_KERNELS}
    print(f"[profile] device busy {busy_ms:.2f} ms in a {window_ms:.2f} ms "
          f"host window (idle {100 * (1 - busy_ms / window_ms):.1f}%); "
          f"hand kernels {hand}")
    print(avgs.table(sort_by="cuda_time_total", row_limit=12))

    # one more step, its NMS results and crop inputs kept aside (read after
    # the step)
    nms_calls, crop_fwd, crop_bwd = [], [], []
    real_nms = proposals.nms_batched
    real_crop = (roi_crop_cuda.roi_crop_forward,
                 roi_crop_cuda.roi_crop_backward)

    def recorded_nms(*nms_in):
        out = real_nms(*nms_in)
        nms_calls.append(nms_in + out)
        return out

    def recorded_crop(*crop_in):
        crop_fwd.append(crop_in)
        return real_crop[0](*crop_in)

    def recorded_crop_bwd(*crop_in):
        crop_bwd.append(crop_in)
        return real_crop[1](*crop_in)

    proposals.nms_batched = recorded_nms
    roi_crop_cuda.roi_crop_forward = recorded_crop
    roi_crop_cuda.roi_crop_backward = recorded_crop_bwd
    try:
        train_step(state, batches[4], gen)
    finally:
        proposals.nms_batched = real_nms
        roi_crop_cuda.roi_crop_forward, roi_crop_cuda.roi_crop_backward = \
            real_crop
    (boxes, valid, thresh, max_out, keep_idx, keep_mask), = nms_calls
    e, n, _ = boxes.shape
    nms_args = (boxes, valid, thresh, max_out)
    kept, last = lane_stats(keep_idx, keep_mask, n, max_out)
    # the kernel alone on this step's input, and its tile loop by phase
    nms_ms = device_ms(lambda: real_nms(*nms_args), 20)
    cycles = phase_cycles(*nms_args, nms_cuda.cluster_size(boxes.device, e,
                                                           n, max_out))
    print(f"[nms] ({e}, {n})->{max_out} in a step: kept/lane {kept}; last "
          f"examined/lane {last}; kernel alone {nms_ms:.4f} ms; cycles a "
          f"tile {cycles}")
    crop = step_crop(crop_fwd, crop_bwd, args.baseline) if crop_bwd else {}
    print(f"[crop] in a step: {crop}")
    print(json.dumps({"device": smi, "variant": args.variant, "images": 2,
                      "expressions": args.expressions, "stages_ms": stages,
                      "caption_stages_ms": caption,
                      "vgg_tail_stages_ms": tail, "peak_gib": peak_gib,
                      "window_ms": window_ms, "device_busy_ms": busy_ms,
                      "hand_kernels_ms": hand,
                      "nms_kept_per_lane": kept,
                      "nms_last_examined_per_lane": last,
                      "nms_alone_ms": nms_ms, "nms_cycles_a_tile": cycles,
                      "crop_in_step": crop}))


if __name__ == "__main__":
    main()
