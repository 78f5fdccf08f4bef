#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lang2seg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):
  1. environment: device, `nvidia-smi` name and power limit, TF32 flags
     (both set off, so f32 matmuls and convolutions run in full f32);
  2. build the CUDA kernels (NMS, the gate, the ROI pool, the ROI crop)
     from lang2seg_tpu_torch/csrc with nvcc for sm_90a, in parallel;
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
     from 2 images (training), K=7 sigmoid normalized and K=1 multiply,
     and at the training shape the `cycle` variant's K=7 multiply gate
     with and without normalize: response within 1e-3 of max|response|,
     and within 1e-5 of it for these bf16 maps (the tensor-core product
     with the filter split in a hi and a lo bf16 part; a one-pass bf16
     product misses this by far), gated within 1 bf16 ulp given the
     kernel's own response (and of the plain version's for the sigmoid
     gate); then its device time at each shape beside its bound, the tile
     plan the wrapper launched it with and its registers (ptxas,
     build.log);
  4b. the gate's backward kernel against its plain version at the
     training shape, the same four gates (the un-normalized K=7 multiply
     with a zero d_resp, as the `cycle` step gives it), given the same
     response: d_conv within 2 bf16 ulps (counted at no less than 2^-8 of
     max|d_conv|), d_filt and d_rfilt within 1e-3 of their max|value|,
     and the same bits on a second call; then its time;
  5. the serving path at full width (ResNet-101-C4 `response` variant,
     random weights from a seed, 640x1024 canvas): 3 requests of 4, 8
     and 16 expressions through Inference.predict and
     Evaluator.eval_image, with the kernel launches counted over them
     (`utils/trace.py`); every request must launch each kernel exactly
     once per forward;
  6. a small input (resnet26, 128x192, f32) served on the card and on
     the CPU (plain versions) from the same weights must agree;
  7. the training path at full width: `Trainer` over 2 images x 16
     expressions (uint8 canvases, bit-packed masks), random weights from
     a seed, at the config's LR: 1 warm-up step (the gate backward's
     d_gated must be a contiguous 16-byte aligned bf16 map), 1 step under
     PyTorch's synchronisation debug mode (which must report no host sync
     inside `train_step`) and 3 timed steps, with the launches counted
     over them. Every step must launch the NMS, the gate
     and the gate's backward exactly once and give finite losses; frozen
     parameters stay bit-identical and every SGD group moves;
  8. one tiny f32 training step (resnet26, 128x192) on the card and on the
     CPU from the same weights, dropout draws and injected targets
     (`tools/tiny_step.py`): the losses and the updates must agree;
  9. phase 7 for the paper's full model, the `cycle_response` preset
     (normalized response, ResNet-101-C4 bf16, 640x1024, config LR): the
     gated map feeds the ROI crop and the caption branch (layer4 on the
     full maps, the att2in2 captioner), so d_gated sums both gradients;
     besides phase 7's checks, `loss_caption` is finite and every
     captioner parameter the loss reaches moves;
  10. phase 8 for the `cycle` preset (the K=7 multiply gate, the caption
     branch on the GT-masked map, no response loss: the backward takes a
     zero d_resp), captioner dropout off;
  11. captioner pretraining at full width: `extract_caption_features` of
     16 expressions over 2 images from the phase-9 network, three Adam
     steps of a fresh captioner (one under the sync debug mode, which must
     report no host sync), then greedy and beam-10 decodes: shapes,
     finite scores, words in the vocabulary (no UNK in a beam), PAD from
     the first EOS on, and the greedy log-probs and beam scores within
     1e-3 of the decoded words rescored by teacher forcing;
  12. the file-backed path at full width: first NMS bit for bit against
     its plain version at the eval sentence buckets' shapes (8, 6000) ->
     300 and (32, 6000) -> 300, and the gate at E = 8 and 32 (stride-0
     map) to phase 4's tolerances, each timed beside its bound with the
     cluster size and tile plan launched; then a mini REFER split built
     in memory (`data/fixtures.py`: 8 BGR images of 427x640 and 640x427,
     2, 3 or 6 refs of 3 sentences an image, RLE masks) through
     `GtBatchLoader` -> `Trainer` for the flagship `response` preset,
     2 images x 16 expressions a step, 6 steps with snapshots every 3
     into a temporary directory; a second `Trainer` resumed from iter_3
     must hold the model, optimizer, generator and loader state that was
     saved, bit for bit, and draw the uninterrupted run's 4th batch;
     `Evaluator.eval_split` scores the val and testA images through the
     bucketed (8, 16, 32) mask-bank wire, each image launching NMS and
     the gate once. Printed: the loader's host ms a batch, the step ms
     with the prefetcher against phase 7's, eval images/s by bucket;
  13. the closed-loop learning proof (`tools/learn_synthetic.py`) at the
     settings of tests/test_learning.py: resnet26, 128x192, f32, 1 filter,
     sigmoid gate, response loss, 8 classes, 600 SGD steps at LR 2e-4
     (x0.1 at 450) from scratch, scored by `eval_split` before and after:
     untrained det acc <= 0.25, trained det acc >= 0.75, trained IoU >=
     0.5 and at least 0.4 above the untrained one;
  14. the detection-only `vgg` preset at full width
     (`flagship_config("vgg")`: VGG16 in bf16, C4 512, 7 filters, sigmoid
     gate, normalized response, random weights from a seed): first the
     gate at (16, 40, 64, 512) bf16, forward through a stride-0 map and a
     gathered one and backward, to phases 4 and 4b's tolerances and timed
     beside their bounds; then 3 requests of 4, 8 and 16 expressions
     through Inference.predict and a detection-only Evaluator.eval_image
     (each launching NMS and the gate once), and phase 7's training
     checks on 5 `Trainer` steps of 2 images x 16 expressions (conv1_* and
     conv2_* frozen bit for bit, no host sync, NMS, the gate and its
     backward once a step);
  15. phase 8 for the tiny `vgg` step (VGG16's fc6 / fc7 dropout drawn
     for both devices from one CPU generator);
  16. the evaluator's host modes on the card: a mini REFER split
     (`data/fixtures.py`) scored through `cli.eval` with the flagship
     `response` model by device paste, by host paste (`--host-paste`: det
     acc identical, IoU within 1e-3) and in the reference-exact mode
     (`--reference-exact`: det acc identical, IoU in [0, 1]); one 768 x
     1024 image, beyond the 640 x 640 paste buffers, pasted back on the
     host; test mode 'top' at rpn_top_n 5000 on one image of 2
     expressions (no NMS launch), with its peak memory;
  17. the Mask R-CNN pretraining stage at full width
     (`flagship_config("pretrain")`: ResNet-101-C4 in bf16, no language,
     M = 8 GT boxes and masks an image, random weights from a seed): (a)
     NMS bit for bit against its plain version at the step's (2, 12000)
     -> 2000 (one lane an image) on an RPN draw, timed beside its bound
     with the cluster size launched; (b) a raw REFER tree and a COCO-style
     instances.json (`data/fixtures.py::write_mini_refer`: 8 REFER images
     of 427x640 and 640x427, 4 of them val / testA, and 4 COCO images
     without refs; polygon, uncompressed-RLE, crowd and degenerate
     annotations) in a temporary directory; `make_coco_minus_refer` must
     drop exactly the val / testA images; `CocoDetectionLoader` (flips on)
     -> `to_wire` -> `train_step`; (c) a warm-up step, one under the sync
     debug mode (no host sync inside `train_step`) and three timed steps
     (upload to sync), with the loader's host ms a batch and the peak
     memory; (d) every step launches NMS once, with 2 lanes, and the gate
     and its backward never, gives finite losses with `loss_mask` and no
     `loss_response`; frozen parameters bit-identical, every SGD group
     moves; (e) a loader restored from its state_dict draws the same next
     batch; (f) the pretrain state_dict goes into a `response` `Trainer`
     through `load_pretrained`: every pretrain tensor taken as it is, only
     language keys missing; (g) that Trainer runs one full-width step (NMS,
     the gate and its backward once) on a `GtBatchLoader` over the same
     raw tree prepro'd in memory (`REFER` -> `prepro_data`, no h5py);
  18. phase 8 for the tiny `pretrain` step (2 images with 4 GT boxes and
     masks each; with targets injected and no language it launches no
     kernel);
  19. the attribute head at full width (`flagship_config()` with
     `use_attribute_head`, 50 attributes, random weights from a seed): a
     raw REFER tree (`write_mini_refer`) with a 50-word attribute file
     (`write_attribute_file`) prepro'd in memory -> `GtBatchLoader` (2
     images x 16 expressions with `att_labels` / `att_valid`) -> phase 7's
     checks on a `Trainer` (NMS, the gate and its backward once a step,
     no host sync, frozen tensors fixed, every SGD group moving), with a
     finite `loss_att` every step and `att_head` moving; then
     `eval_attributes` over `iter_attribute_batches` (16 refs an image)
     with `predict_attribute_scores` on the card: scores in [0, 1],
     P / R / F1 each -1 or in [0, 1], ms an image;
  20. comprehension at full width (the `response` model, random weights):
     `ComprehensionEvaluator.eval_split` over phase 12's val and testA
     images at the sentence buckets 8 / 16 / 32 (candidates: the distinct
     GT boxes), then `eval_split_dets` over a dets file in the
     reference's flat format written here (none for the first images of
     buckets 8 and 32, `max_cands` 32, so that the other bucket-32 image
     scores 32 x 32 candidates): the gate once an image and NMS never,
     finite scores, `n` the valid sentences less `skipped_no_dets`; ms an
     image by bucket;
  21. the caption side at full width (`cycle_response`: captioner 512
     wide, vocabulary 2000, 10 words): (a) captioner pretraining on phase
     11's features for each of `show_tell`, `fc`, `topdown`,
     `show_attend_tell` and `adaatt`, three Adam steps each (finite
     losses, every parameter moves); (b) phase 9's checks on
     `cycle_response` with the `topdown` decoder; (c)
     `cli.eval_captions.score_caption_split` (att2in2, beam 10) over phase
     12's val images: BLEU-1..4, ROUGE_L, CIDEr and METEOR, finite, ms an
     image;
  22. phase 8 for the tiny `response_att` (attribute labels injected)
     and `topdown` steps;
  23. the ROI max-pool kernels (`csrc/roi_pool.cu`: the forward holding
     each expression's 32-byte channel slab in shared memory and writing a
     one-byte bin-local argmax, the backward adding in a shared-memory f32
     slab) against their plain versions on the card
     (`tools/profile_roi_pool.py`): 16 x 256 ROIs on (16, 40, 64, 512)
     and (16, 40, 64, 1024) bf16 maps gathered from 2 images (training,
     the forward with its argmax), 16 x 300 ROIs on 16 distinct maps of
     each width (serving: the gate's per-expression output, no argmax),
     with edge ROIs (off the map, 1 x 1, empty bins, corners on .5 after
     scaling, windows of ties) and an oversize ROI (bins too large for a
     one-byte code, rescanned by the backward): forward and decoded argmax
     bit for bit, backward within 1 bf16 ulp, and the same checks on the
     draw without the oversize ROI; then each kernel's device time beside
     its bound on that draw (the first kernels' inputs), and with the
     oversize ROI, each shape's GB/s, kernel and slab plan, and the kernels'
     phase clocks (a -DROI_POOL_PHASE_CLOCKS build); a stride-0 map (16
     x 300) and an f32 map (16 x 256) checked forward and backward too,
     and the large-map routes (`LARGE_SHAPE`, 120 x 128: the forward's
     global scan, the backward in bands, two-byte codes). After phase 26,
     every other shape at which phases 24-26 launched the kernels (the
     requests of 4 and 8 expressions, the mask crops of 1 and 2 boxes an
     expression, the demo's one expression) is checked and timed the same
     way, and every launch on the 40 x 64 map must have run a
     shared-memory kernel (the slab or few-ROI forward, the one-band
     backward: the launch keys name the kernel run);
  24. MobileNetV1 + ROI max pooling at full width (`flagship_config()`
     with backbone mobilenet_v1, C4 512, pooling_mode pool; random
     weights from a seed): phase 7's checks on a Trainer of 2 images x 16
     expressions (NMS, the gate and its backward, the ROI pool kernel and
     its backward once a step, no host sync, the BatchNorm buffers
     fixed, every SGD group moving; step ms and peak memory), then phase
     5's requests at E = 4, 8 and 16; then one
     ResNet-101 `response` step and one E = 16 request in pool mode (the
     kernel at C = 1024);
  25. phase 8 for the tiny `mobilenet_pool` step (the ROI pool kernel and
     its backward once each on the card);
  26. `cli.demo.main` on the synthetic fixture on the card, `--variant
     response` and again with phase 24's overrides: the annotated PNG and
     the response map's (signature, IHDR, CRCs, rows inflating to the
     image), ms of `main` and of a warm request (`cli.demo.annotate`);
     then one full-width Trainer validation with `debug_save_dir` (the
     response map and 5 channel PNGs);
  27. the evaluator's throughput modes at full width (the `response`
     model, random weights from a seed): (a) `tools/profile_eval.py`'s
     mix (24 images of 3 to 13 valid sentences in the buckets 4 / 8 / 16,
     the mask bank, uint8 canvases) through `Evaluator.eval_split` at 1
     and 4 images a dispatch, the extent crop on and off, staged uploads
     on and off: every mode scores the det_correct and seg_correct of one
     image a dispatch with the crop off, and each valid sentence as it
     does (the same selected box within 0.01 pixels, I / U within 4
     pixels), the crop on the crop off's state and sentences bit for
     bit, each dispatch launches NMS and the gate once (counted over a
     pass) with no host sync under the sync
     debug mode; then one chunk of 4 bucket-32 images (128 expressions)
     the same way; (b) every shape at which these passes launched NMS or
     the gate and that no earlier phase reports (NMS at 4, 64 and 128
     lanes; the gate through the stride-0 map at E = 4, and on 4 maps
     read by 4, 8, 16 or 32 expressions each and on 2 maps read by 4,
     `exprs_per_map`): NMS bit for bit against its plain version at
     (E, 6000) -> 300 on an RPN draw, the gate to phase 4's tolerances,
     each timed beside its bound with its cluster size or tile plan; the
     passes must have launched NMS at 32, 64 and 128 lanes and the gate
     on 4 maps read by 8, 16 and 32; (c) printed: valid expressions/s
     and images/s, host -> device bytes, each dispatch's device span and
     the peak memory of each mode (from its checked pass), the device's
     idle share of a pass (torch.profiler) at 1 and 4 images a dispatch
     with the crop on and staged uploads, the bucket-32 chunk's peak;
  28. the train step as a CUDA graph (`make_multi_train_step`): the
     port's SGD (the LR read from device tensors) against torch SGD's
     foreach step on the card, bit for bit; then for `response` and
     `cycle_response` at full width (2 images x 16 expressions, RPN
     12000 -> 2000) 3 dispatches of K = 4 and for MobileNetV1 + pool 3 of
     K = 2 (the ROI pool kernels inside the graph), each with an LR decay
     inside the run, against as many eager `train_step`s from the same
     weights, batches and generator seed: every parameter, momentum
     buffer, the generator's state and every step's losses bit for bit;
     the first dispatch's launches (the warm step and K - 1 replays: K a
     kernel, the capture none), and over the last dispatch each kernel's
     count equal to its runs traced by name (K a kernel); eager and
     graphed ms
     a step (windows ending in a sync), the capture's s, the idle share of
     eager steps and of a graphed dispatch under torch.profiler, the
     graphed run's peak memory;
  29. data parallel at world size 1 over NCCL (a file:// rendezvous):
     `make_sharded_train_step` against `train_step` on one batch with
     expr_uid and the same generators, bit for bit; then a sharded step
     and 2 dispatches of `make_sharded_multi_step` (K = 4, the NCCL
     all-reduce captured in the graph) against 9 eager sharded steps, bit
     for bit; the sharded step and the first dispatch launch each kernel
     5 times (the sharded step, the warm step, 3 replays; the capture
     none), and over the second dispatch each kernel's count equals its
     runs traced by name (4 a kernel);
  30. two ranks on the one card over gloo (NCCL refuses two ranks on one
     card; gloo with CUDA tensors is this check's configuration): two
     processes of this script (`--dp-rank R DIR`) take one sharded step
     on the two blocks of a full-width batch with expr_uid, against the
     shardwise oracle in this process (each block's gradients in turn,
     averaged, one update): parameters, momentum, losses and generators
     bit for bit; then `eval_split_mesh` over phase 12's val and testA
     images against one process's `eval_split`, equal;
  31. the ROI crop kernels (`csrc/roi_crop.cu`: a 4-tap bilinear gather
     forward, a thread an (expression, ROI, sample column, 16-byte channel
     vector) walking the sample rows, streaming stores; a fixed-order
     backward, a CTA of one warp an (expression, 4 pixels of a row, slab
     of channels), a lane a channel vector with its sums in registers,
     the warp walking the ROIs in order and summing only their terms on
     its pixels, each element summed in the one order (ROI, sample column),
     no atomics) against their plain versions (`tools/profile_crop.py`)
     at serving 16 x 300, training 16 x 256 (C = 1024 and 512), the mask
     crops 16 x 2, the attribute crops 16 x 1 and test mode 'top' 16 x
     5000 (compared in chunks of ROIs), with edge ROIs: the forward the
     bits of its algorithm in torch ops and within 3 bf16 ulps (at the
     scale of the crop of |map|) of the einsum pair, the backward the bits
     of its fixed-order plain version, the same bits on a second run, and
     within 3 ulps (at the scale of the backward of |grad|) of autograd of
     the einsum pair; each timed beside its bound, the plain versions and one
     `F.grid_sample` call (library_ms); then one full-width test-mode
     'top' request of 16 expressions (R = 5000) through Inference.predict,
     its ms and peak memory; last, every other shape at which phases 5-31
     launched the crop kernels is checked and timed the same way;
  32. the frozen-BatchNorm kernels (`csrc/bn_act.cu`: BatchNorm, residual
     or the downsample branch's BatchNorm, and ReLU in one pass, a thread
     a 16-byte channel vector with its (inv, offset) in registers walking
     pixels, streaming loads and stores; the backward from the saved
     output) against the plain composition at `profile_bn_act.SHAPES`
     (layer4 at the serving 4,800 and training 4,096 crops, the
     backbone's maps), forward and backward, bit for bit, each timed
     beside its bound and the plain version; the host's cost of a call
     beside the composition's (`profile_bn_act.host_us`); then one
     full-width serving request (16 expressions) through
     Inference.predict and one full-width `response` forward and
     backward (2 images x 16 expressions) with the kernels and again with
     the ResNet's BatchNorms as the plain composition
     (`profile_bn_act.unfused`): the outputs, the losses and every
     gradient bit for bit;
  33. the ResNet-101 head replayed as a CUDA graph against its eager pass
     (`tools/profile_head.py`) at the serving shape (1 image of 640 x
     1024) and the eval shape (4 images): bit for bit, host and device ms
     a call, the runtime calls a call (at most 6 graphed), the first
     call's seconds and the graph pool's bytes.
  34. the conditioning with its language half (bi-LSTM and filter
     heads) replayed as a CUDA graph against its eager pass
     (`tools/profile_condition.py`) at the serving shape (16 expressions
     on one map) and each eval mix dispatch shape (1, 2 or 4 maps of 4, 8
     or 16 expressions): the filters, gated map and response bit for bit,
     host and device ms a call, the runtime calls a call (at most 12
     graphed), the first call's seconds, the pool's bytes; one capture a
     label shape, no eager call, and the head graph's counters unchanged.
Then one `{"kernels": [...]}` line (one NMS entry and one gate entry per
shape, its launches from the runs of that shape's path: serving in phases
5, 14 and 24 and the bucket-16 images of phases 12, 16 and 20, training in
phases 7, 9, 12, 14, 17g, 19, 21b, 24, 28 and 29 (the warm steps and
every replay) and 30 (both ranks), the eval buckets 8 and 32 in phases
12, 16 and 20, the pretraining shape (2, 12000) -> 2000 in phase 17's
steps, phase 27's dispatches at each entry's shape (every shape they
launched a kernel at has an entry; NMS at 4, 64 and 128 lanes and the
gate at E = 4 and on 4 or 2 maps only there); the gate's backward's from
training; the C = 512 gate's from phases 14, 24 and 28 (MobileNetV1);
the ROI pool entries, one for each shape at which phases 24-26 and 28
launched the forward or the backward, with the launches at exactly that
shape; the ROI crop entries, one for each shape at which phases 5-31
launched its forward or backward, the counters' change from phase 5 to
phase 31 with phase 30's ranks' counts added; the frozen-BatchNorm
entries of phase 32, one a shape and pass, with the launches phases 5-31
made at exactly that shape, counted as the crop's are; phase 32's own
launches are not among them. A CUDA graph's replays count their pass,
its capture nothing: `utils/trace.py`)
and, last, the `{"ok": true, ...}` line. Details go to
chiprun_out/chip_smoke.json. Exits non-zero without a CUDA device or
outside a checkout of the repository.
"""

import collections
import copy
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from lang2seg_tpu_torch.cli import demo as cli_demo  # noqa: E402
from lang2seg_tpu_torch.cli import eval as cli_eval  # noqa: E402
from lang2seg_tpu_torch.cli import eval_captions  # noqa: E402
from lang2seg_tpu_torch.config import (  # noqa: E402
    Config, apply_variant, flagship_config, load_config)
from lang2seg_tpu_torch.data.coco_detection import (  # noqa: E402
    CocoDetectionLoader, make_coco_minus_refer)
from lang2seg_tpu_torch.data.fixtures import (  # noqa: E402
    mini_refer_split, write_attribute_file, write_mini_refer)
from lang2seg_tpu_torch.data.loader import (  # noqa: E402
    CycleBatchLoader, GtBatchLoader)
from lang2seg_tpu_torch.data.prepro import (  # noqa: E402
    DEFAULT_MAX_LENGTH, prepro_data)
from lang2seg_tpu_torch.data.refer import REFER  # noqa: E402
from lang2seg_tpu_torch.data.synthetic import (  # noqa: E402
    FixedBatchLoader, synthetic_batch, synthetic_eval_request, to_wire)
from lang2seg_tpu_torch.engine.attributes import (  # noqa: E402
    attribute_scorer, eval_attributes)
from lang2seg_tpu_torch.engine.checkpoint import CheckpointManager  # noqa: E402
from lang2seg_tpu_torch.engine.comprehension import (  # noqa: E402
    ComprehensionEvaluator, DetsLoader)
from lang2seg_tpu_torch.engine.evaluator import Evaluator  # noqa: E402
from lang2seg_tpu_torch.engine.inference import Inference  # noqa: E402
from lang2seg_tpu_torch.engine.train_captioner import (  # noqa: E402
    captioner_train_step, extract_caption_features, init_captioner_state)
from lang2seg_tpu_torch.engine.optimizer import SGD, set_lr  # noqa: E402
from lang2seg_tpu_torch.engine.train_state import (  # noqa: E402
    _forward_backward, create_train_state, make_multi_train_step,
    stack_batches, to_device, train_step)
from lang2seg_tpu_torch.engine.trainer import Trainer  # noqa: E402
from lang2seg_tpu_torch.models.network import build_model  # noqa: E402
from lang2seg_tpu_torch.ops import (  # noqa: E402
    _build, fused_filter, nms_cuda, proposals, roi_crop_cuda, roi_pool_cuda)
from lang2seg_tpu_torch.ops.fused_filter import (  # noqa: E402
    fused_dynamic_filter_bwd_plain, fused_dynamic_filter_plain,
    per_expression)
from lang2seg_tpu_torch.ops.nms import nms_padded  # noqa: E402
from lang2seg_tpu_torch.parallel import (  # noqa: E402
    initialize_multihost, make_sharded_multi_step, make_sharded_train_step,
    shard_batch, sync_replicas)
from lang2seg_tpu_torch.parallel.train import (  # noqa: E402
    dropout_generator, sampling_generator, shardwise_step)
from lang2seg_tpu_torch.tools.profile_gate import (  # noqa: E402
    SHAPES as GATE_SHAPES, bf16_ulp_distance, bf16_ulps_floored, gate_bound,
    gate_bwd_bound, gate_inputs, kernel_registers)
from lang2seg_tpu_torch.tools.profile_nms import (  # noqa: E402
    MAIN_SHAPES, device_ms, edge_cases, lane_stats, nms_bound, rpn_draw,
    time_ms)
from lang2seg_tpu_torch.tools.profile_roi_pool import (  # noqa: E402
    LARGE_SHAPE as LARGE_POOL_SHAPE, POOLED, SHAPES as POOL_SHAPES,
    check_shape as check_pool_shape, checks_pass as pool_checks_pass,
    compare_shape as compare_pool_shape, phase_clocks as pool_phase_clocks)
from lang2seg_tpu_torch.tools import learn_synthetic  # noqa: E402
from lang2seg_tpu_torch.tools import profile_bn_act  # noqa: E402
from lang2seg_tpu_torch.tools import profile_condition  # noqa: E402
from lang2seg_tpu_torch.tools import profile_crop  # noqa: E402
from lang2seg_tpu_torch.tools import profile_eval  # noqa: E402
from lang2seg_tpu_torch.tools import profile_head  # noqa: E402
from lang2seg_tpu_torch.tools.tiny_step import card_vs_cpu  # noqa: E402
from lang2seg_tpu_torch.utils import trace  # noqa: E402
from lang2seg_tpu_torch.utils.metrics import SegEvalAccumulator  # noqa: E402
from lang2seg_tpu_torch.utils.timer import Timer  # noqa: E402
from lang2seg_tpu_torch.utils.visualization import decode_png  # noqa: E402
from lang2seg_tpu_torch.weights import (  # noqa: E402
    init_params, state_dict_shapes)

OUT = os.path.join(REPO, "chiprun_out")
record = {}
# the main-path runs whose launches of a kernel's counter a `kernels` entry
# of that path reports: serving (phase 5) and the eval images of the 16
# bucket (phases 12, 16 and 20) and the ResNet-101 pool request (phase
# 24); training, the response step (phase 7), the cycle_response step
# (phase 9), the file-backed run (phase 12), phase 17's response step on
# the pretrain weights, the attribute head's steps (phase 19), the topdown
# cycle_response steps (phase 21b) and the ResNet-101 pool step (phase 24)
LAUNCHED_BY = {"serve": lambda counter: (("serve", counter),
                                         ("eval_file_16", counter),
                                         ("host_modes_16", counter),
                                         ("comprehension_16", counter),
                                         ("serve_resnet_pool", counter),
                                         ("eval_modes", EVAL_MODE_KEY_16[
                                             counter])),
               "train": lambda counter: (("train", counter),
                                         ("train_cycle", counter),
                                         ("train_file", counter),
                                         ("recipe_link", counter),
                                         ("train_att", counter),
                                         ("train_topdown", counter),
                                         ("train_resnet_pool", counter),
                                         ("graph_response", counter),
                                         ("graph_cycle", counter),
                                         ("dp_world1", counter),
                                         ("dp_gloo", counter))}
# phase 27's launches at the serving shape: one image of 16 sentences a
# dispatch (NMS at 16 lanes, the gate through the stride-0 map)
EVAL_MODE_KEY_16 = {"nms": "nms_16", "fused_filter": "fused_filter_1x16"}
# NMS runs at the same shapes in the `vgg` preset (phase 14) and on
# MobileNetV1 (phase 24): their requests and steps count towards the NMS
# entries, their C = 512 gate to its own
VGG_NMS_RUNS = {"serve": (("serve_vgg", "nms"),
                          ("serve_mobilenet", "nms")),
                "train": (("train_vgg", "nms"), ("train_mobilenet", "nms"),
                          ("graph_mobilenet", "nms"))}
EVAL_BUCKETS = (8, 16, 32)
# the mini REFER split of phases 12, 20 and 21c: (image sizes, refs an
# image, splits); 8 images, 4 of them val / testA with 6 to 18 sentences
FILE_SPLIT = (((427, 640), (640, 427)) * 4, (2, 3, 6, 3, 2, 6, 3, 6),
              ("train",) * 4 + ("val",) * 2 + ("testA",) * 2)


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
    # the sources, and the ROI pool kernels' phase-clock build (phase 23)
    paths = _build.build_all(list(_build.SOURCE_FLAGS) + ["roi_pool_clocks"])
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
               "launched_by": LAUNCHED_BY[path]("nms") + VGG_NMS_RUNS[path]}
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

# (K, gate, normalize): the main path's gate and K=1; at the training shape
# also the `cycle` variant's K=7 multiply gate
GATE_CASES = ((7, "sigmoid", True), (1, "multiply", False))
GATE_CYCLE_CASES = ((7, "multiply", True), (7, "multiply", False))


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
        cases = GATE_CASES + (GATE_CYCLE_CASES if path == "train" else ())
        for seed, (k, gate, norm) in enumerate(cases):
            conv, filt, rfilt, _, _ = gate_inputs(e, h, w, c, k, maps, dev,
                                                  seed=seed)
            if not norm:
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
            if (k, gate) == (7, "sigmoid"):          # the main path's gate
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
               "launched_by": LAUNCHED_BY[path]("fused_filter")}
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
    for seed, (k, gate, norm) in enumerate(GATE_CASES + GATE_CYCLE_CASES):
        conv, filt, rfilt, d_gated, d_resp = gate_inputs(
            e, h, w, c, k, maps, dev, seed=10 + seed)
        if not norm:
            filt = filt * 0.03
        if (k, gate, norm) == (7, "multiply", False):
            # the `cycle` step: no loss reads the response, so its
            # cotangent is the zeros autograd materialises
            d_resp = torch.zeros_like(d_resp)
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
        log(f"[gate-bwd] K={k} {gate} normalize={norm}"
            f"{' d_resp=0' if not d_resp.any() else ''}: d_conv {ulps:.2f} "
            f"bf16 ulp (floored; raw max {raw_ulps}), max abs {dconv_err:.3e};"
            f" d_filt err {errs[0]:.3e} (tol {tols[0]:.3e}); d_rfilt err "
            f"{errs[1]:.3e} (tol {tols[1]:.3e}); repeatable={same}")
        check(ulps <= 2.0, "gate backward d_conv beyond 2 bf16 ulps")
        check(errs[0] <= tols[0], "gate backward d_filt out of tolerance")
        check(errs[1] <= tols[1], "gate backward d_rfilt out of tolerance")
        check(same, "gate backward not repeatable")
        check(got[0].dtype == torch.bfloat16 and got[0].shape == conv.shape)
        if (k, gate) == (7, "sigmoid"):
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
           "launched_by": LAUNCHED_BY["train"]("fused_filter_bwd")}
    log(f"[gate-bwd] {name} (gathered map) bf16 K=7: kernel {ms:.4f} ms "
        f"device time (back-to-back calls {events_ms:.4f} ms), plain "
        f"{plain_ms:.3f} ms, bound {bound * 1e3:.2f} us ({by}: {byts} B, "
        f"{ops} ops); plan {res['tile_plan']}, {regs['backward']}")
    record["fused_filter_bwd"] = dict(res, bytes=byts, ops=ops,
                                      events_ms=events_ms,
                                      d_filt_err=errs[0], d_rfilt_err=errs[1])
    return res


# ---------------------------------------------------------- launch counts

# the hand kernels' launch counters (`utils/trace.py`) by the names this
# script, and `profile_eval.kernel_launches` in a trace, give the kernels
COUNTERS = {"nms": "nms.launches", "fused_filter": "gate.launches",
            "fused_filter_bwd": "gate.bwd_launches",
            "roi_pool": "roi_pool.launches",
            "roi_pool_bwd": "roi_pool.bwd_launches",
            "roi_crop": "roi_crop.launches",
            "roi_crop_bwd": "roi_crop.bwd_launches",
            "bn_act": "bn_act.launches", "bn_act_bwd": "bn_act.bwd_launches"}


class Launches:
    """The kernels' launches since it was made, read from the counters:
    `of(*kernels)` in total, `by_shape(kernel)` by shape (the crop, pool
    and frozen-BatchNorm kernels). A graph's replay counts its pass, its
    capture nothing."""

    def __init__(self):
        self.totals = trace.counters()
        self.keyed = {k: trace.by_key(name) for k, name in COUNTERS.items()}

    def of(self, *kernels):
        now = trace.counters()
        return tuple(now.get(COUNTERS[k], 0) - self.totals.get(COUNTERS[k], 0)
                     for k in kernels)

    def by_shape(self, kernel):
        return collections.Counter(trace.by_key(COUNTERS[kernel])) - \
            collections.Counter(self.keyed[kernel])

    def pool_shapes(self):
        """The ROI pool kernels' launches by shape, for a run's entry of
        `runs`."""
        return {"roi_pool_shapes": self.by_shape("roi_pool"),
                "roi_pool_bwd_shapes": self.by_shape("roi_pool_bwd")}

    def record(self):
        """The launches as a record of `trace.add` (another process's,
        added to this one's counters)."""
        out = collections.Counter()
        for kernel, name in COUNTERS.items():
            keyed = self.by_shape(kernel)
            out.update({(name, key): n for key, n in keyed.items()})
            rest = self.of(kernel)[0] - sum(keyed.values())
            if rest:
                out[name, None] += rest
        return out


# ---------------------------------------------------------------- phase 5

def serve_full_width():
    """Phase 5: the flagship `response` model, requests of 4, 8 and 16
    expressions (`serve_requests`; COCO images are <= 640 a side, scaled
    by 1.6 they fill the canvas)."""
    cfg = flagship_config()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[serve] flagship response model built in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.state_dict().values())} weights)")
    launches = serve_requests("serve", cfg, model=model)[0]
    check(record["serve"]["sentences"] == (28, 28))
    check(launches["nms"] > 0 and launches["fused_filter"] > 0)
    return launches


def serve_requests(path, cfg, sizes=((4, 1), (8, 2), (16, 3)), model=None):
    """Requests of `sizes` expressions (synthetic uint8 images at scale
    1.6) through Inference.predict, with the masks of 2 boxes an
    expression when the model has a mask head, and Evaluator.eval_image:
    each forward launches NMS and the gate once, and the ROI pool kernel
    once in pool mode; outputs finite and of their shapes. Returns (the
    launch counts, the last request's outputs)."""
    model = model or build_model(cfg, device="cuda", seed=0)
    m = cfg.model
    inf, ev = Inference(model, cfg), Evaluator(model, cfg)
    for num_expr, seed in sizes:
        ev.eval_image(synthetic_eval_request(cfg, num_expr, 100 + seed, 1.6),
                      SegEvalAccumulator())
    torch.cuda.synchronize()
    acc, timings = SegEvalAccumulator(), []
    torch.cuda.reset_peak_memory_stats()
    since = Launches()
    pool = m.pooling_mode == "pool"
    # predict: the box head's ROI pool or crop; eval_image: that and, with
    # a mask head, the pool or crop of each expression's box
    want = (1, 1, int(pool), int(not pool))
    want_eval = (1, 1) + tuple(x * (1 + int(m.use_mask_head))
                               for x in want[2:])

    def counts():
        return since.of("nms", "fused_filter", "roi_pool", "roi_crop")
    for num_expr, seed in sizes:
        b = synthetic_eval_request(cfg, num_expr, seed, 1.6)
        c0 = counts()
        t0 = time.perf_counter()
        out = inf.predict(b["images"], b["im_hw"], b["labels"])
        torch.cuda.synchronize()
        t_pred = (time.perf_counter() - t0) * 1e3
        check(tuple(b - a for a, b in zip(c0, counts())) == want,
              f"a {path} request launched other than {want}")
        r = cfg.test.rpn_post_nms_top_n
        shapes = {"rois": (num_expr, r, 4), "roi_valid": (num_expr, r),
                  "cls_prob": (num_expr, r, 81),
                  "bbox_pred": (num_expr, r, 324),
                  "gated_conv": (num_expr, 40, 64, m.c4_feat_dim),
                  "response": (num_expr, 40, 64, 1)}
        for k, shp in shapes.items():
            check(tuple(out[k].shape) == shp, (k, tuple(out[k].shape)))
            if k != "roi_valid":
                check(bool(torch.isfinite(out[k].float()).all()), k)
        check(out["gated_conv"].dtype == model.compute_dtype)
        check(bool(out["roi_valid"].any(1).all()))
        if m.use_mask_head:
            masks = inf.boxes_to_masks(out["gated_conv"], out["rois"][:, :2],
                                       torch.ones((num_expr, 2),
                                                  dtype=torch.int64))
            check(masks.shape == (num_expr, 2, 14, 14)
                  and bool(((masks >= 0) & (masks <= 1)).all()))
        c0 = counts()
        t0 = time.perf_counter()
        ev.eval_image(b, acc)
        torch.cuda.synchronize()
        t_eval = (time.perf_counter() - t0) * 1e3
        launched = tuple(b - a for a, b in zip(c0, counts()))
        check(launched == want_eval,
              f"a {path} eval_image launched {launched}, not {want_eval}")
        timings.append({"expressions": num_expr, "predict_ms": t_pred,
                        "eval_image_ms": t_eval})
        log(f"[{path}] request E={num_expr}: predict {t_pred:.1f} ms, "
            f"eval_image {t_eval:.1f} ms")
    launches = dict(zip(("nms", "fused_filter", "roi_pool", "roi_crop"),
                        counts()))
    summary = acc.summary()
    check(all(0.0 <= float(v) <= 1.0 for v in summary.values()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{path}] main-path launches {launches}; det acc "
        f"{summary['det_acc']:.4f}; peak device memory {peak:.2f} GiB")
    record[path] = {"timings": timings, "launches": launches,
                    "metrics": {k: float(v) for k, v in summary.items()},
                    "sentences": (acc.num_sent, acc.seg_total),
                    "peak_gib": peak}
    return dict(launches, **since.pool_shapes()), out


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


# ------------------------------------------------------------ phases 7, 9

def host_syncs(fn):
    """fn() under PyTorch's CUDA synchronisation debug mode: (its result,
    the host synchronisations the mode reported)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(x.message) for x in caught if
                 "called a synchronizing CUDA operation" in str(x.message)]


def record_gate_bwd_inputs():
    """Wraps the gate's backward so that the next step's call keeps its
    d_gated and d_resp (read after the step); returns (calls, undo)."""
    calls, real = [], fused_filter.fused_dynamic_filter_bwd

    def recorded(*args):
        calls.append((args[4], args[5]))
        return real(*args)

    fused_filter.fused_dynamic_filter_bwd = recorded

    def undo():
        fused_filter.fused_dynamic_filter_bwd = real
    return calls, undo


def train_full_width(path, cfg, batches=None):
    """`Trainer` at full width, 2 images x 16 expressions (uint8 canvases,
    bit-packed masks), random weights from a seed, at the config's LR: a
    warm-up step (its gate-backward inputs recorded), one step under the
    sync debug mode, three timed steps, the launches counted over them.
    `batches` (4 in the wire formats, default synthetic ones) are taken
    in turn. Returns (launches, trainer)."""
    num_images, num_expr = 2, 16
    if batches is None:
        batches = [to_wire(cfg, synthetic_batch(cfg, num_images, num_expr,
                                                seed=s)) for s in range(4)]
    t0 = time.perf_counter()
    trainer = Trainer(cfg, FixedBatchLoader(batches), device="cuda", seed=0)
    model = trainer.state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    log(f"[{path}] model and SGD built in {time.perf_counter() - t0:.1f} s; "
        f"lr {cfg.train.learning_rate}, "
        f"{len(trainer.state.optimizer.param_groups)} groups")

    buffers = {n: b.clone() for n, b in model.named_buffers()}
    pool = cfg.model.pooling_mode == "pool"
    # per step: NMS, the gate, its backward once each, and the ROI pool
    # kernel and its backward in pool mode, else the ROI crop kernels, once
    # each (twice with the attribute head's crops at the GT boxes)
    k = 1 + int(cfg.model.use_attribute_head)
    want_step = (1, 1, 1) + ((k, k, 0, 0) if pool else (0, 0, k, k))
    kernels = ("nms", "fused_filter", "fused_filter_bwd", "roi_pool",
               "roi_pool_bwd", "roi_crop", "roi_crop_bwd")
    since = Launches()

    def counts():
        return since.of(*kernels)

    bwd_inputs, undo = record_gate_bwd_inputs()
    t0 = time.perf_counter()
    try:
        steps = [trainer.train(1)]                      # warm-up
    finally:
        undo()
    torch.cuda.synchronize()
    log(f"[{path}] warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms")
    per_step = [counts()]
    (d_gated, d_resp), = bwd_inputs
    bwd_in = {"d_gated_dtype": str(d_gated.dtype),
              "d_gated_contiguous": d_gated.is_contiguous(),
              "d_gated_align16": d_gated.data_ptr() % 16 == 0,
              "d_resp_all_zero": not bool(d_resp.any())}
    log(f"[{path}] the gate backward's inputs: {bwd_in}")
    check(bwd_in["d_gated_dtype"] == str(model.compute_dtype)
          and bwd_in["d_gated_contiguous"] and bwd_in["d_gated_align16"],
          "d_gated is not a contiguous 16-byte aligned map of the compute "
          "dtype")
    del bwd_inputs, d_gated, d_resp
    # one step with the sync debug mode on: any host synchronisation inside
    # train_step is reported (the batch is uploaded before, the losses read
    # after)
    batch = to_device(batches[1], "cuda")
    c0 = counts()
    losses, syncs = host_syncs(
        lambda: train_step(trainer.state, batch, trainer.generator))
    # control: reading a loss is a host sync, and the mode must report it
    _, control = host_syncs(lambda: float(losses["total_loss"]))
    log(f"[{path}] step 2 under the sync debug mode: {len(syncs)} host "
        f"synchronisations {syncs[:3]} (control, a loss read: "
        f"{len(control)})")
    check(control, "the sync debug mode did not report a loss read")
    check(not syncs, "the train step synchronises with the host")
    steps.append({k: float(v) for k, v in losses.items()})
    per_step.append(tuple(b - a for a, b in zip(c0, counts())))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3, 6):
        c0 = counts()
        t0 = time.perf_counter()
        steps.append(trainer.train(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(b - a for a, b in zip(c0, counts())))
    launches = dict(zip(kernels, counts()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{path}] step ms {[round(t, 2) for t in times]} (mean "
        f"{sum(times) / len(times):.2f}); peak device memory {peak:.2f} GiB; "
        f"launches per step (nms, gate, gate bwd, roi pool, roi pool bwd, "
        f"roi crop, roi crop bwd) {per_step}")
    for i, ls in enumerate(steps):
        log(f"[{path}] step {i + 1} losses "
            f"{ {k: round(v, 4) for k, v in sorted(ls.items())} }")
        check(all(np.isfinite(v) for v in ls.values()),
              f"non-finite loss at step {i + 1}")
    check(all(c == want_step for c in per_step),
          "a train step did not launch each kernel exactly once")
    check(trainer.state.step == 5)
    after = dict(model.named_parameters())
    frozen = [n for n, p in after.items() if not p.requires_grad]
    # MobileNetV1 freezes no parameter (every conv trains, as in the JAX
    # package); its BatchNorms, like every backbone's, are buffers
    check((frozen or cfg.model.backbone == "mobilenet_v1")
          and all(torch.equal(before[n], after[n]) for n in frozen),
          "a frozen parameter changed")
    check(all(torch.equal(buffers[n], b) for n, b in model.named_buffers()),
          "a BatchNorm buffer changed")
    moved = {}
    for grp in trainer.state.optimizer.param_groups:
        n_moved = sum(int(not torch.equal(before[n], p))
                      for n, p in zip(grp["names"], grp["params"]))
        moved[f"x{grp['lr_mult']:g} wd {grp['weight_decay']:g}"] = \
            f"{n_moved}/{len(grp['params'])}"
        check(n_moved > 0, f"SGD group {grp['lr_mult']} did not move")
    log(f"[{path}] {len(frozen)} frozen parameters and {len(buffers)} "
        f"buffers bit-identical; moved per group {moved}")
    entry = {"step_ms": times, "peak_gib": peak,
             "lr": cfg.train.learning_rate, "launches": launches,
             "launches_per_step": per_step, "losses": steps,
             "moved_per_group": moved, "host_syncs": len(syncs),
             "gate_bwd_inputs": bwd_in}
    if cfg.model.use_caption_loss:
        check(all("loss_caption" in ls for ls in steps))
        cap = {n: not torch.equal(before[n], p) for n, p in after.items()
               if n.startswith("caption_model.")}
        # att2in2 embeds its fc features but never reads them: the fc
        # embed gets no gradient, and its weight decay alone (LR x 1e-4 x
        # |w|) is below its f32 rounding
        unmoved = sorted(n for n, m in cap.items() if not m)
        log(f"[{path}] captioner parameters moved: {sum(cap.values())}/"
            f"{len(cap)}; unmoved {unmoved}")
        check(all(n.startswith("caption_model.fc_embed.") for n in unmoved),
              f"captioner parameters did not move: {unmoved}")
        entry["captioner_unmoved"] = unmoved
    if cfg.model.use_attribute_head:
        check(all("loss_att" in ls for ls in steps), "a step without loss_att")
        head = {n: not torch.equal(before[n], p) for n, p in after.items()
                if n.startswith("att_head.")}
        log(f"[{path}] loss_att by step "
            f"{[round(ls['loss_att'], 4) for ls in steps]}; att_head moved: "
            f"{head}")
        check(len(head) == 2 and all(head.values()), "att_head did not move")
    record[path] = entry
    return dict(launches, **since.pool_shapes()), trainer


# ------------------------------------------------------------ phases 8, 10

def small_train_reference(path, variant, launches=(0, 1, 1, 0, 0),
                          min_tensors=40):
    """One tiny f32 SGD step on the card (kernels) and on the CPU (plain
    versions) from the same weights, dropout draws and injected targets
    (`tools/tiny_step.py`): the losses within 1e-4 relative, each update
    within 1e-3 in relative L2 norm (a tensor whose exact gradient is zero,
    `tiny_step.ROUNDING_ONLY`, within 1e-8 in norm instead) over at least
    `min_tensors` tensors, nothing moved on the card only; the card's step
    makes `launches` (NMS, gate, gate backward, ROI pool, ROI pool
    backward): the gate and its backward once with language, nothing
    without (NMS is skipped by the injected targets), the ROI pool kernel
    and its backward once in pool mode."""
    errs, launched = card_vs_cpu(variant)
    loss_err = errs["loss_rel_err"]
    log(f"[{path}] card vs CPU, tiny f32 {variant} step: loss rel err max "
        f"{max(loss_err.values()):.2e} over {sorted(loss_err)}; update rel "
        f"L2 err max {errs['update_rel_err_max']:.2e} ({errs['worst']}) over "
        f"{errs['tensors']} tensors; card launches {launched}")
    check(launched == launches, f"the tiny step launched {launched}, not "
          f"{launches}")
    check(max(loss_err.values()) <= 1e-4, ("losses", loss_err))
    check(errs["update_rel_err_max"] <= 1e-3,
          ("updates", errs["worst"], errs["update_rel_err_max"]))
    check(not errs["moved_on_card_only"] and errs["tensors"] >= min_tensors,
          (errs["moved_on_card_only"], errs["tensors"]))
    # the attention logits' bias has a zero gradient in exact arithmetic:
    # its update is rounding, ~1e-12 on the CPU, where the smallest real
    # captioner update is ~1e-6
    check(errs["rounding_only_max"] <= 1e-8,
          ("rounding-only update", errs["rounding_only_max"]))
    record[path] = errs


# --------------------------------------------------------------- phase 11

def pretrain_captioner(cfg, model):
    """Captioner pretraining and decoding at full width: the 'res5_2'
    features of 16 expressions over 2 images from the phase-9 network,
    three Adam steps of a fresh captioner (the second under the sync
    debug mode), then greedy and beam-10 decodes. Returns the features
    and captions (fc, att, seq, mask)."""
    batch = to_device(to_wire(cfg, synthetic_batch(cfg, 2, 16, seed=7)),
                      "cuda")
    t0 = time.perf_counter()
    fc, att = extract_caption_features(model, batch)
    torch.cuda.synchronize()
    t_feat = (time.perf_counter() - t0) * 1e3
    check(fc.shape == (16, 4096) and att.shape == (16, 196, 4096))
    check(bool(torch.isfinite(fc).all() and torch.isfinite(att).all()),
          "non-finite caption features")
    state = init_captioner_state(cfg, device="cuda", seed=0)
    seq, mask = batch["cap_labels"], batch["cap_masks"]
    losses, times = [], []
    for i in range(3):
        t0 = time.perf_counter()
        if i == 1:
            loss, syncs = host_syncs(lambda: captioner_train_step(
                state, fc, att, seq, mask))
        else:
            loss = captioner_train_step(state, fc, att, seq, mask)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    log(f"[captioner] features {t_feat:.1f} ms; Adam steps "
        f"{[round(t, 2) for t in times]} ms, losses "
        f"{[round(v, 4) for v in losses]}; step 2 under the sync debug mode: "
        f"{len(syncs)} host synchronisations {syncs[:3]}")
    check(all(np.isfinite(v) for v in losses), "non-finite captioner loss")
    check(not syncs, "the captioner step synchronises with the host")
    cap = state.captioner.eval()
    t0 = time.perf_counter()
    gseq, glp = cap.sample_greedy(fc, att)
    torch.cuda.synchronize()
    t_greedy = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    bseq, bscore = cap.sample_beam(fc, att, beam_size=10)
    torch.cuda.synchronize()
    t_beam = (time.perf_counter() - t0) * 1e3
    t, v = cfg.model.cap_seq_length, cfg.model.cap_vocab_size
    rescored = {}
    # the greedy decode may pick UNK (index v), the beam never (it costs 1000)
    for name, sq, val, top in (("greedy", gseq, glp, v),
                               ("beam", bseq, bscore, v - 1)):
        check(sq.shape == (16, t) and val.shape[0] == 16, name)
        check(bool(torch.isfinite(val).all()), f"{name}: non-finite scores")
        check(int(sq.min()) >= 0 and int(sq.max()) <= top,
              f"{name}: a word out of the vocabulary")
        # PAD from the first EOS on: the running max of (word == 0) marks
        # the suffix, which must be all zeros
        ended = torch.cummax((sq == 0).int(), dim=1).values.bool()
        check(not bool(sq[ended].any()), f"{name}: a word after EOS")
        # each word's log-prob under teacher forcing of the decoded words,
        # counted up to and including the first EOS
        with torch.no_grad():
            logp = cap.teacher_forced_logprobs(
                fc, att, torch.cat([torch.zeros_like(sq[:, :1]), sq], 1))
        lp = torch.gather(logp, -1, sq[..., None])[..., 0]
        counted = ~torch.cat([torch.zeros_like(ended[:, :1]), ended[:, :-1]], 1)
        rescored[name] = (lp, counted)
    # the greedy step's log-probs and the beam's scores against the same
    # words rescored in one teacher-forced pass (f32, the time steps'
    # logits batched): within 1e-3
    lp, counted = rescored["greedy"]
    greedy_err = float((glp - lp)[counted].abs().max())
    lp, counted = rescored["beam"]
    beam_err = float((bscore - (lp * counted).sum(1)).abs().max())
    log(f"[captioner] greedy {t_greedy:.1f} ms, beam 10 {t_beam:.1f} ms; "
        f"first greedy row {gseq[0].tolist()}, first beam row "
        f"{bseq[0].tolist()} (score {float(bscore[0]):.3f}); against the "
        f"words rescored by teacher forcing: greedy log-probs {greedy_err:.2e},"
        f" beam scores {beam_err:.2e}")
    check(greedy_err <= 1e-3, ("greedy log-probs", greedy_err))
    check(beam_err <= 1e-3, ("beam scores", beam_err))
    record["captioner"] = {"features_ms": t_feat, "adam_step_ms": times,
                           "losses": losses, "host_syncs": len(syncs),
                           "greedy_ms": t_greedy, "beam10_ms": t_beam,
                           "greedy_rescore_err": greedy_err,
                           "beam_rescore_err": beam_err}
    return fc, att, seq, mask


# --------------------------------------------------------------- phase 12

# NMS at the eval sentence buckets no other phase runs: (lanes, boxes,
# draw seed, thresh, max_out)
EVAL_NMS_SHAPES = ((8, 6000, 3, 0.7, 300), (32, 6000, 4, 0.7, 300))


def check_nms_shape(dev, e, n, seed, thr, max_out, launched_by, tag,
                    key=None):
    """NMS bit for bit against its plain version at (e, n) -> max_out on
    an RPN draw, timed beside its bound with the cluster size launched;
    returns its `kernels` entry (recorded under `key`, default its
    name)."""
    boxes = rpn_draw(e, n, seed, dev)
    valid = torch.ones((e, n), dtype=torch.bool, device=dev)
    ki, km = nms_cuda.nms_batched(boxes, valid, thr, max_out)
    pi, pm = nms_padded(boxes, valid, thr, max_out)
    torch.cuda.synchronize()
    same = torch.equal(ki, pi) and torch.equal(km, pm)
    err = max(float((ki - pi).abs().max()), float((km != pm).sum()))
    kept, _ = lane_stats(ki, km, n, max_out)
    check(same, f"NMS kernel differs from its plain version at ({e}, {n})")
    call = (lambda: nms_cuda.nms_batched(boxes, valid, thr, max_out))
    ms = device_ms(call, 50)
    plain_ms = time_ms(lambda: nms_padded(boxes, valid, thr, max_out), 2)
    bound, by, byts, ops = nms_bound(ki, km, n, max_out)
    csize = nms_cuda.cluster_size(dev, e, n, max_out)
    res = {"name": f"nms_{e}x{n}_{max_out}", "route": "cuda",
           "source": "lang2seg_tpu_torch/csrc/nms.cu",
           "replaces": "lang2seg_tpu/ops/nms_pallas.py:196",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "cluster_size": csize, "launched_by": launched_by}
    log(f"[{tag}] nms ({e}, {n})->{max_out}: bit-identical={same} "
        f"kept/lane={kept}; kernel {ms:.4f} ms device time ({csize} CTAs a "
        f"lane), plain {plain_ms:.2f} ms, bound {bound * 1e3:.3f} us ({by}: "
        f"{byts} B, {ops} ops)")
    record[key or res["name"]] = dict(res, bytes=byts, ops=ops)
    return res


def check_gate_shape(dev, regs, conv, filt, rfilt, per_map, maps, name,
                     launched_by, tag):
    """The gate (K=7 sigmoid normalized) on `conv`, expression e reading
    map e // per_map, against its plain version to phase 4's tolerances,
    timed beside its bound (`maps` maps read); returns its `kernels`
    entry."""
    e, c = filt.shape[:2]
    h, w = conv.shape[1:3]
    args = (conv, filt, rfilt, 7, "sigmoid", True, per_map)
    gk, rk = fused_filter.fused_dynamic_filter(*args)
    plan = fused_filter.plans["forward"]
    gp, rp = fused_dynamic_filter_plain(*args)
    torch.cuda.synchronize()
    resp_err = float((rk - rp).abs().max())
    resp_tol = 1e-5 * float(rp.abs().max())
    ulps = int(bf16_ulp_distance(gk.float(), gp.float()).max())
    same_g = (per_expression(conv, per_map).float()
              * torch.sigmoid(rk)).to(torch.bfloat16)
    ulps_given_resp = int(bf16_ulp_distance(gk.float(),
                                            same_g.float()).max())
    check(resp_err <= resp_tol, f"gate response out of tolerance at {name}")
    check(ulps <= 1 and ulps_given_resp <= 1,
          f"gate gated map beyond 1 bf16 ulp at {name}")
    check(plan["grid"][1] == e, "gate forward plan of another shape")
    ms = device_ms(lambda: fused_filter.fused_dynamic_filter(*args), 50)
    plain_ms = time_ms(lambda: fused_dynamic_filter_plain(*args), 5)
    bound, by, byts, ops = gate_bound(e, h, w, c, 7, 2, maps)
    res = {"name": name, "route": "cuda",
           "source": "lang2seg_tpu_torch/csrc/fused_filter.cu",
           "replaces": "lang2seg_tpu/ops/pallas_kernels.py:85",
           "max_abs_err": float((gk.float() - gp.float()).abs().max()),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by, "library_ms": None,
           "tile_plan": {"grid": plan["grid"],
                         "tile_pixels": plan["tile_pixels"],
                         "tiles_per_block": plan["tiles_per_block"]},
           "registers": regs["forward"]["registers"],
           "launched_by": launched_by}
    log(f"[{tag}] gate ({e}, {h}, {w}, {c}) bf16 K=7, {maps} map(s) read "
        f"by {per_map if maps > 1 else e} expressions each: resp err "
        f"{resp_err:.3e} (tol {resp_tol:.3e}), gated {ulps} bf16 ulp "
        f"({ulps_given_resp} given its response); kernel {ms:.4f} ms device "
        f"time, plain {plain_ms:.3f} ms, bound {bound * 1e3:.2f} us ({by}); "
        f"plan {res['tile_plan']}")
    record[name] = dict(res, bytes=byts, ops=ops, resp_max_abs_err=resp_err)
    return res


def check_eval_kernels(dev, regs):
    """NMS bit for bit against its plain version at (8, 6000) -> 300 and
    (32, 6000) -> 300 (RPN draws), the gate at E = 8 and 32 through a
    stride-0 map (K=7 sigmoid normalized, bf16) to phase 4's tolerances;
    each timed beside its bound."""
    results = []
    for e, n, seed, thr, max_out in EVAL_NMS_SHAPES:
        results.append(check_nms_shape(
            dev, e, n, seed, thr, max_out,
            ((f"eval_file_{e}", "nms"), (f"host_modes_{e}", "nms"),
             (f"comprehension_{e}", "nms"), ("eval_modes", f"nms_{e}")),
            "eval-kernels"))
    for e in (8, 32):
        conv, filt, rfilt = gate_inputs(e, 40, 64, 1024, 7, "broadcast", dev,
                                        seed=20 + e)[:3]
        results.append(check_gate_shape(
            dev, regs, conv, filt, rfilt, 1, 1, f"fused_filter_eval{e}",
            ((f"eval_file_{e}", "fused_filter"),
             (f"host_modes_{e}", "fused_filter"),
             (f"comprehension_{e}", "fused_filter"),
             ("eval_modes", f"fused_filter_1x{e}")), "eval-kernels"))
    return results


def same_loader_state(a, b):
    ra, rb = a["rng_state"], b["rng_state"]
    return (a["iterators"] == b["iterators"]
            and set(a["perm"]) == set(b["perm"])
            and all(np.array_equal(a["perm"][k], b["perm"][k])
                    for k in a["perm"])
            and ra[0] == rb[0] and np.array_equal(ra[1], rb[1])
            and tuple(ra[2:]) == tuple(rb[2:]))


def same_optimizer_state(a, b):
    ga = [{k: v for k, v in g.items() if k != "params"}
          for g in a["param_groups"]]
    gb = [{k: v for k, v in g.items() if k != "params"}
          for g in b["param_groups"]]
    return (ga == gb and set(a["state"]) == set(b["state"])
            and all(torch.equal(a["state"][i]["momentum_buffer"],
                                b["state"][i]["momentum_buffer"])
                    for i in a["state"]))


def file_backed_path(phase7_ms):
    """Phase 12's main path: loader -> Trainer (6 steps, snapshots every
    3) -> resume from iter_3 -> eval_split over the bucketed test
    batches. Returns the launch counts of its training run and of its
    eval run by bucket."""
    cfg = flagship_config()
    t = cfg.train
    t.images_per_batch, t.expressions_per_batch = 2, 16
    t.snapshot_iters, t.display, t.summary_interval = 3, 1, 10 ** 9
    info, labels, read = mini_refer_split(*FILE_SPLIT, seed=0)

    def loader(seed):
        return GtBatchLoader(info, labels, cfg, seed=seed, read_image=read)

    probe = loader(cfg.seed)
    cfg.model.vocab_size = cfg.model.cap_vocab_size = probe.vocab_size
    host_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        probe.get_batch("train")
        host_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[file] mini REFER split: {len(info['images'])} images, "
        f"{len(info['refs'])} refs, {len(labels)} sentences, vocabulary "
        f"{probe.vocab_size}; loader host ms a 2 x 16 batch "
        f"{[round(x, 1) for x in host_ms]}")
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as tmp:
        run_a, run_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        trainer = Trainer(cfg, loader(cfg.seed), run_a, device="cuda", seed=0)
        trained = ("nms", "fused_filter", "fused_filter_bwd")
        since = Launches()
        trainer.train(3)
        torch.cuda.synchronize()
        check(since.of(*trained) == (3, 3, 3), "a file-backed step did not "
              "launch each kernel once")
        saved = {"model": {k: v.clone() for k, v in
                           trainer.state.model.state_dict().items()},
                 "optimizer": copy.deepcopy(
                     trainer.state.optimizer.state_dict()),
                 "generator": trainer.generator.get_state(),
                 "loader": copy.deepcopy(trainer.loader.state_dict())}
        shutil.copytree(run_a, run_b)
        trainer.timer = Timer()
        t0 = time.perf_counter()
        trainer.train(6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = since.of(*trained)
        runs["train_file"] = dict(zip(trained, launched))
        step_ms = trainer.timer.average_time("step") * 1e3
        ckpts = sorted(int(d.split("_")[1])
                       for d in os.listdir(os.path.join(run_a, "ckpt")))
        log(f"[file] 6 steps: launches (nms, gate, gate bwd) {launched}; "
            f"steps 4-6 {step_ms:.2f} ms a step with the prefetcher (phase 7:"
            f" {phase7_ms:.2f} ms), {wall:.2f} s with the iter_6 snapshot; "
            f"snapshots {ckpts}")
        check(launched == (6, 6, 6), "a file-backed step did not launch "
              "each kernel once")
        check(ckpts == [3, 6] and trainer.state.step == 6)

        resumed = Trainer(cfg, loader(99), run_b, device="cuda", seed=1)
        check(resumed.try_resume() == 3, "no resume from iter_3")
        on_disk, host = CheckpointManager(os.path.join(run_b, "ckpt")
                                          ).restore(3, map_location="cuda")
        sd = resumed.state.model.state_dict()
        same = {
            "model": all(torch.equal(sd[k], v) and
                         torch.equal(on_disk["model"][k], v)
                         for k, v in saved["model"].items()),
            "optimizer": same_optimizer_state(
                resumed.state.optimizer.state_dict(), saved["optimizer"]),
            "generator": torch.equal(resumed.generator.get_state(),
                                     saved["generator"]),
            "loader": same_loader_state(resumed.loader.state_dict(),
                                        saved["loader"])
            and same_loader_state(host["loader_state"], saved["loader"]),
            "step": resumed.state.step == 3}
        replay = loader(cfg.seed)
        want = [replay.get_batch("train") for _ in range(4)][-1]
        got = resumed.loader.get_batch("train")
        same["batch_4"] = set(got) == set(want) and all(
            np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
            for k in want)
        log(f"[file] resumed from iter_3, bit-identical to the saved state: "
            f"{same}")
        check(all(same.values()), f"resume is not bit-identical: {same}")
        del resumed, on_disk

    ev = Evaluator(trainer.state.model, cfg, device="cuda")
    per_image, dispatch = [], ev.dispatch_image

    def counted(batch, sent_valid=None):
        c0 = Launches()
        rec = dispatch(batch, sent_valid)
        per_image.append((batch["labels"].shape[0],
                          *c0.of("nms", "fused_filter")))
        return rec

    ev.dispatch_image = counted
    acc = SegEvalAccumulator()
    since = Launches()
    t0 = time.perf_counter()
    for split in ("val", "testA"):
        ev.eval_split(probe.iter_test_batches(split, buckets=EVAL_BUCKETS),
                      acc=acc)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    ev.dispatch_image = dispatch
    summary = acc.summary()
    log(f"[file] eval_split of val + testA ({len(per_image)} images, "
        f"{acc.num_sent} sentences) in {t_eval:.2f} s, loader included: "
        f"(bucket, nms, gate) a dispatch {per_image}; "
        f"{ {k: round(float(v), 4) for k, v in summary.items()} }")
    check(all(n == 1 and f == 1 for _, n, f in per_image),
          "an eval image did not launch NMS and the gate once")
    check(since.of("nms", "fused_filter") == (len(per_image),
                                              len(per_image)))
    check(sorted({s for s, _, _ in per_image}) == list(EVAL_BUCKETS))
    check(acc.num_sent == 51 and acc.seg_total == 51)
    check(all(0.0 <= float(v) <= 1.0 for v in summary.values()))
    for b in EVAL_BUCKETS:
        k = sum(1 for s, _, _ in per_image if s == b)
        runs[f"eval_file_{b}"] = {"nms": k, "fused_filter": k}

    # eval images/s by bucket, on prebuilt batches (no loader time): 8
    # dispatches of the bucket's images, after one warm pass
    by_bucket = {}
    for split in ("val", "testA"):
        for b in probe.iter_test_batches(split, buckets=EVAL_BUCKETS):
            by_bucket.setdefault(b["labels"].shape[0], []).append(b)
    rates = {}
    for s, group in sorted(by_bucket.items()):
        reps = (group * 8)[:8]
        ev.eval_split(group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev.eval_split(reps)
        torch.cuda.synchronize()
        rates[s] = len(reps) / (time.perf_counter() - t0)
    log(f"[file] eval images/s by bucket (prebuilt batches, pipeline depth "
        f"4): { {s: round(r, 2) for s, r in rates.items()} }")
    record["file_backed"] = {
        "loader_host_ms": host_ms, "step_ms": step_ms,
        "phase7_step_ms": phase7_ms, "six_steps_s": wall,
        "launches_train": runs["train_file"], "resume_same": same,
        "eval_per_image": per_image, "eval_seconds": t_eval,
        "eval_metrics": {k: float(v) for k, v in summary.items()},
        "eval_images_per_s": rates}
    del trainer, ev
    return runs


# --------------------------------------------------------------- phase 13

def learning_proof():
    """tests/test_learning.py's closed loop on the card, held to its
    bounds (`:71-74`)."""
    t0 = time.perf_counter()
    res = learn_synthetic.run(["--steps", "600", "--lr", "2e-4",
                               "--decay-at", "450", "--eval-every", "200"])
    wall = time.perf_counter() - t0
    u, t = res["untrained"], res["trained"]
    fmt = (lambda s: {k: round(float(v), 4) for k, v in s.items()})  # noqa: E731
    log(f"[learn] untrained {fmt(u)}")
    log(f"[learn] trained {fmt(t)}")
    log(f"[learn] (step, loss, det acc, IoU) {res['history']}; 600 steps "
        f"{res['train_seconds']:.1f} s, wall {wall:.1f} s with the evals")
    check(u["det_acc"] <= 0.25, ("untrained det acc", u["det_acc"]))
    check(t["det_acc"] >= 0.75, ("trained det acc", t["det_acc"]))
    check(t["overall_iou"] >= 0.5, ("trained IoU", t["overall_iou"]))
    check(t["overall_iou"] >= u["overall_iou"] + 0.4, "IoU did not rise "
          "by 0.4")
    record["learning_proof"] = {
        "untrained": {k: float(v) for k, v in u.items()},
        "trained": {k: float(v) for k, v in t.items()},
        "history": res["history"], "train_seconds": res["train_seconds"],
        "wall_seconds": wall}


# ------------------------------------------------------------ phases 14-16

VGG_GATE = (16, 40, 64, 512, 7)          # E, H, W, C, K of the `vgg` gate


def vgg_gate_registers():
    """ptxas's registers a thread of the C = 512 bf16 gate kernels (K=7,
    sigmoid; the backward at G = C / 4 threads a pixel), None where the
    build log has no line for one."""
    regs = kernel_registers(_build.library_path("fused_filter").with_name(
        "build.log"))
    want = {"forward": "fused_filter_mma_kernel<7, 512, true>",
            "backward": "fused_filter_bwd_kernel<__nv_bfloat16, 7, 128, true>"}
    out = {}
    for kind, key in want.items():
        hits = [v[0] for name, v in regs.items() if key in name]
        out[kind] = hits[0] if len(hits) == 1 else None
    return out


def check_gate_vgg(dev):
    """Phase 14's kernels: the gate at the `vgg` width, (16, 40, 64, 512)
    bf16 K=7 sigmoid normalized, forward through a stride-0 map (serving)
    and a gathered one (training) to phase 4's tolerances, the backward on
    the gathered map to phase 4b's; each timed beside its bound."""
    e, h, w, c, k = VGG_GATE
    regs = vgg_gate_registers()
    results = []
    for seed, (maps, path) in enumerate((("broadcast", "serve_vgg"),
                                         ("gathered", "train_vgg"))):
        conv, filt, rfilt, d_gated, d_resp = gate_inputs(
            e, h, w, c, k, maps, dev, seed=30 + seed)
        args = (conv, filt, rfilt, k, "sigmoid", True)
        gk, rk = fused_filter.fused_dynamic_filter(*args)
        gp, rp = fused_dynamic_filter_plain(*args)
        torch.cuda.synchronize()
        resp_err = float((rk - rp).abs().max())
        resp_tol = 1e-5 * float(rp.abs().max())
        ulps = int(bf16_ulp_distance(gk.float(), gp.float()).max())
        same_g = (conv.float() * torch.sigmoid(rk)).to(torch.bfloat16)
        ulps_given_resp = int(bf16_ulp_distance(gk.float(),
                                                same_g.float()).max())
        log(f"[vgg-gate] {maps} map ({e}, {h}, {w}, {c}) bf16 K=7: resp err "
            f"{resp_err:.3e} (tol {resp_tol:.3e}), gated {ulps} bf16 ulp "
            f"({ulps_given_resp} given its response)")
        check(resp_err <= resp_tol, "C = 512 gate response out of tolerance")
        check(ulps <= 1 and ulps_given_resp <= 1,
              "C = 512 gate gated map beyond 1 bf16 ulp")
        call = (lambda a=args: fused_filter.fused_dynamic_filter(*a))
        ms = device_ms(call, 50)
        plan = fused_filter.plans["forward"]
        check(plan["grid"][1] == e, "gate forward plan of another shape")
        plain_ms = time_ms(lambda a=args: fused_dynamic_filter_plain(*a), 5)
        nmaps = 1 if maps == "broadcast" else e
        bound, by, byts, ops = gate_bound(e, h, w, c, k, 2, nmaps)
        res = {"name": f"fused_filter_vgg_{path.split('_')[0]}",
               "route": "cuda",
               "source": "lang2seg_tpu_torch/csrc/fused_filter.cu",
               "replaces": "lang2seg_tpu/ops/pallas_kernels.py:85",
               "max_abs_err": float((gk.float() - gp.float()).abs().max()),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": by, "library_ms": None,
               "tile_plan": {"grid": plan["grid"],
                             "tile_pixels": plan["tile_pixels"],
                             "tiles_per_block": plan["tiles_per_block"]},
               "registers": regs["forward"],
               "launched_by": ((path, "fused_filter"),
                               (path.replace("vgg", "mobilenet"),
                                "fused_filter"))
               + ((("graph_mobilenet", "fused_filter"),)
                  if path == "train_vgg" else ())}
        log(f"[vgg-gate] {maps}: kernel {ms:.4f} ms device time, plain "
            f"{plain_ms:.3f} ms, bound {bound * 1e3:.2f} us ({by}: {byts} B, "
            f"{ops} ops); plan {res['tile_plan']}, registers {regs}")
        record[res["name"]] = dict(res, bytes=byts, ops=ops,
                                   resp_max_abs_err=resp_err)
        results.append(res)
    # the backward on the gathered map, as trained
    bargs = (conv, filt, rfilt, rk, d_gated, d_resp, k, "sigmoid", True)
    got = fused_filter.fused_dynamic_filter_bwd(*bargs)
    want = fused_dynamic_filter_bwd_plain(*bargs)
    again = fused_filter.fused_dynamic_filter_bwd(*bargs)
    torch.cuda.synchronize()
    ulps = bf16_ulps_floored(got[0], want[0])
    dconv_err = float((got[0].float() - want[0].float()).abs().max())
    errs = [float((a - b).abs().max()) for a, b in zip(got[1:], want[1:])]
    tols = [1e-3 * float(b.abs().max()) for b in want[1:]]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[vgg-gate-bwd] d_conv {ulps:.2f} bf16 ulp (floored), max abs "
        f"{dconv_err:.3e}; d_filt err {errs[0]:.3e} (tol {tols[0]:.3e}); "
        f"d_rfilt err {errs[1]:.3e} (tol {tols[1]:.3e}); repeatable={same}")
    check(ulps <= 2.0, "C = 512 gate backward d_conv beyond 2 bf16 ulps")
    check(errs[0] <= tols[0] and errs[1] <= tols[1],
          "C = 512 gate backward d_filt / d_rfilt out of tolerance")
    check(same, "C = 512 gate backward not repeatable")
    call = (lambda: fused_filter.fused_dynamic_filter_bwd(*bargs))
    ms = device_ms(call, 50)
    plan = fused_filter.plans["backward"]
    plain_ms = time_ms(lambda: fused_dynamic_filter_bwd_plain(*bargs), 5)
    bound, by, byts, ops = gate_bwd_bound(e, h, w, c, k, 2, e)
    res = {"name": "fused_filter_bwd_vgg", "route": "cuda",
           "source": "lang2seg_tpu_torch/csrc/fused_filter.cu",
           "replaces": "lang2seg_tpu/ops/pallas_kernels.py:147",
           "max_abs_err": max([dconv_err] + errs), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": None,
           "tile_plan": {"grid": plan["grid"],
                         "tile_pixels": plan["tile_pixels"],
                         "tiles_per_block": plan["tiles_per_block"]},
           "registers": regs["backward"],
           "launched_by": (("train_vgg", "fused_filter_bwd"),
                           ("train_mobilenet", "fused_filter_bwd"),
                           ("graph_mobilenet", "fused_filter_bwd"))}
    log(f"[vgg-gate-bwd] kernel {ms:.4f} ms device time, plain "
        f"{plain_ms:.3f} ms, bound {bound * 1e3:.2f} us ({by}: {byts} B, "
        f"{ops} ops); plan {res['tile_plan']}")
    record["fused_filter_bwd_vgg"] = dict(res, bytes=byts, ops=ops,
                                          d_filt_err=errs[0],
                                          d_rfilt_err=errs[1])
    results.append(res)
    return results


def serve_vgg():
    """Phase 14's serving: the detection-only `vgg` model at full width,
    3 requests of 4, 8 and 16 expressions through Inference.predict and
    Evaluator.eval_image, each launching NMS and the gate once
    (`serve_requests`); no mask branch (boxes_to_masks refuses)."""
    cfg = flagship_config("vgg")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[serve-vgg] vgg model built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.state_dict().values())} weights)")
    launches, out = serve_requests("serve_vgg", cfg, model=model)
    try:
        Inference(model, cfg).boxes_to_masks(
            out["gated_conv"], out["rois"][:, :2],
            torch.ones((16, 2), dtype=torch.int64))
        refused = False
    except ValueError:
        refused = True
    check(refused, "a detection-only model served masks")
    check(record["serve_vgg"]["sentences"] == (28, 0))
    return launches


def train_vgg():
    """Phase 14's training: phase 7's checks on the `vgg` preset; the
    frozen parameters are exactly conv1_* and conv2_*."""
    launches, trainer = train_full_width("train_vgg", flagship_config("vgg"))
    frozen = sorted(n for n, p in trainer.state.model.named_parameters()
                    if not p.requires_grad)
    check(frozen == sorted(f"vgg.features.{i}.{p}" for i in (0, 2, 5, 7)
                           for p in ("weight", "bias")),
          f"the vgg frozen set is {frozen}")
    check(all("loss_mask" not in ls for ls in record["train_vgg"]["losses"]))
    return launches


def host_modes():
    """Phase 16: the evaluator's host paths on the card. The flagship
    `response` model is first trained 6 steps on the mini REFER split (as
    in phase 12), so that its masks overlap the GT ones, and saved as a
    params file for `cli.eval --params`. Returns the launch counts of its
    eval images by sentence bucket."""
    info, labels, read = mini_refer_split(
        ((427, 640), (640, 427)) * 4, (2, 3, 6, 3, 2, 6, 3, 6),
        ("train",) * 4 + ("val",) * 2 + ("testA",) * 2, seed=0)

    def in_memory(loader_cls, prepro_dir, cfg):
        loader = loader_cls(info, labels, cfg, seed=cfg.seed, read_image=read)
        cfg.model.vocab_size = cfg.model.cap_vocab_size = loader.vocab_size
        return loader

    cfg = flagship_config()
    cfg.train.images_per_batch, cfg.train.expressions_per_batch = 2, 16
    cfg.train.display = cfg.train.summary_interval = 10 ** 9
    trainer = Trainer(cfg, in_memory(GtBatchLoader, None, cfg),
                      device="cuda", seed=0)
    trainer.train(6)
    trained = {k: v.detach().clone()
               for k, v in trainer.state.model.state_dict().items()}
    del trainer

    per_image, dispatch = [], Evaluator.dispatch_image

    def counted(self, batch, sent_valid=None):
        c0 = Launches()
        rec = dispatch(self, batch, sent_valid)
        per_image.append((batch["labels"].shape[0],
                          *c0.of("nms", "fused_filter")))
        return rec

    real_open = cli_eval.open_loader
    cli_eval.open_loader = in_memory
    Evaluator.dispatch_image = counted
    results, seconds = {}, {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
            params = os.path.join(tmp, "trained.pth")
            torch.save(trained, params)
            for mode, flags in (("device_paste", []),
                                ("host_paste", ["--host-paste"]),
                                ("reference_exact", ["--reference-exact"])):
                t0 = time.perf_counter()
                res = cli_eval.main(
                    ["--variant", "response", "--output-dir", tmp,
                     "--params", params, "--splits", "val", "testA",
                     "--set", "model.normalize_response", "true"] + flags)
                torch.cuda.synchronize()
                seconds[mode] = time.perf_counter() - t0
                results[mode] = {sp: {k: float(v) for k, v in r.items()}
                                 for sp, r in res.items()}
                log(f"[host-modes] cli.eval {mode}: "
                    f"{ {sp: {k: round(v, 4) for k, v in r.items()} for sp, r in results[mode].items()} }"
                    f" in {seconds[mode]:.1f} s (model build included)")
    finally:
        cli_eval.open_loader = real_open
        Evaluator.dispatch_image = dispatch
    for sp in ("val", "testA"):
        dev_r, host_r, ref_r = (results[m][sp] for m in
                                ("device_paste", "host_paste",
                                 "reference_exact"))
        check(dev_r["det_acc"] == host_r["det_acc"] == ref_r["det_acc"],
              "det acc differs between the paste modes")
        check(abs(dev_r["overall_iou"] - host_r["overall_iou"]) <= 1e-3,
              ("host vs device paste IoU", sp, dev_r["overall_iou"],
               host_r["overall_iou"]))
        check(all(0.0 <= v <= 1.0 for r in (dev_r, host_r, ref_r)
                  for v in r.values()))
    check(all(n == 1 and f == 1 for _, n, f in per_image),
          "an eval image did not launch NMS and the gate once")

    # one 768 x 1024 image: its original extent exceeds the 640 x 640
    # device buffers, so its masks are pasted back on the host
    big_info, big_labels, big_read = mini_refer_split(
        ((768, 1024),), (3,), ("val",), seed=5)
    loader = GtBatchLoader(big_info, big_labels, cfg, seed=0,
                           read_image=big_read)
    model = build_model(cfg, device="cuda", state_dict=trained)
    ev = Evaluator(model, cfg)
    batch = loader.get_test_batch("val", buckets=EVAL_BUCKETS)
    c0 = Launches()
    t0 = time.perf_counter()
    rec = ev.dispatch_image(batch, batch["sent_valid"])
    acc = SegEvalAccumulator()
    ev.drain(rec, acc)
    t_big = (time.perf_counter() - t0) * 1e3
    per_image.append((batch["labels"].shape[0],
                      *c0.of("nms", "fused_filter")))
    check(per_image[-1][1:] == (1, 1))
    check("probs" in rec and "inter" not in rec,
          "the large image was not pasted back on the host")
    # the spread of each sentence's 14 x 14 probabilities: a constant mask
    # bytescales to all zeros in the reference-exact chain
    spread = (rec["probs"].amax(dim=(1, 2))
              - rec["probs"].amin(dim=(1, 2))).float().cpu().tolist()
    check(acc.seg_total == acc.num_sent == int(batch["sent_valid"].sum()))
    big = {k: float(v) for k, v in acc.summary().items()}
    check(all(0.0 <= v <= 1.0 for v in big.values()))
    log(f"[host-modes] 768 x 1024 image (scaled to {batch['im_hw'][0]}, "
        f"{acc.num_sent} sentences) pasted back on the host in "
        f"{t_big:.1f} ms: {big}; max - min of each sentence's mask "
        f"probabilities {[round(x, 6) for x in spread]}")

    # test mode 'top': the top 5000 anchors by score, no NMS
    top = flagship_config()
    top.test.mode = "top"
    top.model.vocab_size = top.model.cap_vocab_size = cfg.model.vocab_size
    model.cfg = top
    ev_top, inf_top = Evaluator(model, top), Inference(model, top)
    b = synthetic_eval_request(top, 2, seed=9, im_scale=1.6)
    ev_top.eval_image(b, SegEvalAccumulator())             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = Launches()
    t0 = time.perf_counter()
    out = inf_top.predict(b["images"], b["im_hw"], b["labels"])
    torch.cuda.synchronize()
    t_pred = (time.perf_counter() - t0) * 1e3
    check(tuple(out["rois"].shape) == (2, top.test.rpn_top_n, 4)
          and bool(out["roi_valid"].all()))
    check(bool(torch.isfinite(out["cls_prob"]).all()))
    acc = SegEvalAccumulator()
    t0 = time.perf_counter()
    ev_top.eval_image(b, acc)
    torch.cuda.synchronize()
    t_eval = (time.perf_counter() - t0) * 1e3
    top_launches = c0.of("nms", "fused_filter")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(top_launches == (0, 2), "test mode 'top' launched NMS")
    log(f"[host-modes] test mode 'top' (rpn_top_n {top.test.rpn_top_n}, E = 2):"
        f" predict {t_pred:.1f} ms, eval_image {t_eval:.1f} ms, peak "
        f"{peak:.2f} GiB; launches (nms, gate) {top_launches}")
    record["host_modes"] = {
        "cli_eval": results, "cli_eval_seconds": seconds,
        "eval_per_image": per_image, "large_image": big,
        "large_image_ms": t_big, "large_image_prob_spread": spread,
        "top_predict_ms": t_pred,
        "top_eval_image_ms": t_eval, "top_peak_gib": peak,
        "top_launches": top_launches}
    runs = {}
    for b_ in EVAL_BUCKETS:
        k = sum(1 for s_, _, _ in per_image if s_ == b_)
        runs[f"host_modes_{b_}"] = {"nms": k, "fused_filter": k}
    del model, ev, ev_top, inf_top
    return runs


# ------------------------------------------------------------ phases 17-18

# the pretraining step's NMS: one lane an image, (lanes, boxes, draw seed,
# thresh, max_out)
PRETRAIN_NMS = (2, 12000, 6, 0.7, 2000)
# the mini REFER tree of phase 17: COCO's common sizes; 4 train images, 2
# val and 2 testA (which coco_minus_refer must drop), and 4 COCO images
# without refs
PRETRAIN_TREE = dict(image_hw=((427, 640), (640, 427)) * 4,
                     refs_per_image=(2, 3, 4, 3, 2, 3, 3, 2),
                     splits=("train",) * 4 + ("val",) * 2 + ("testA",) * 2,
                     extra_image_hw=((480, 640), (640, 480)) * 2,
                     sents_per_ref=3, seed=17)


def check_nms_pretrain(dev):
    """Phase 17a: NMS bit for bit against its plain version at the
    pretraining step's (2, 12000) -> 2000 on an RPN draw, timed beside its
    bound with the cluster size it is launched with."""
    e, n, seed, thr, max_out = PRETRAIN_NMS
    boxes = rpn_draw(e, n, seed, dev)
    valid = torch.ones((e, n), dtype=torch.bool, device=dev)
    ki, km = nms_cuda.nms_batched(boxes, valid, thr, max_out)
    pi, pm = nms_padded(boxes, valid, thr, max_out)
    torch.cuda.synchronize()
    same = torch.equal(ki, pi) and torch.equal(km, pm)
    err = max(float((ki - pi).abs().max()), float((km != pm).sum()))
    kept, last = lane_stats(ki, km, n, max_out)
    check(same, f"NMS kernel differs from its plain version at ({e}, {n})")
    call = (lambda: nms_cuda.nms_batched(boxes, valid, thr, max_out))
    ms = device_ms(call, 50)
    plain_ms = time_ms(lambda: nms_padded(boxes, valid, thr, max_out), 2)
    bound, by, byts, ops = nms_bound(ki, km, n, max_out)
    csize = nms_cuda.cluster_size(dev, e, n, max_out)
    res = {"name": f"nms_{e}x{n}_{max_out}", "route": "cuda",
           "source": "lang2seg_tpu_torch/csrc/nms.cu",
           "replaces": "lang2seg_tpu/ops/nms_pallas.py:196",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "cluster_size": csize, "launched_by": (("pretrain", "nms"),)}
    log(f"[pretrain] nms ({e}, {n})->{max_out}: bit-identical={same} "
        f"kept/lane={kept} last examined/lane={last}; kernel {ms:.4f} ms "
        f"device time ({csize} CTAs a lane), plain {plain_ms:.2f} ms, bound "
        f"{bound * 1e3:.3f} us ({by}: {byts} B, {ops} ops, "
        f"{bound / ms:.1%} of it)")
    record[res["name"]] = dict(res, bytes=byts, ops=ops, kept=kept)
    return [res]


def record_nms_lanes():
    """Wraps the proposal layer's NMS so that each call's (lanes, boxes,
    max_out) is kept; returns (calls, undo)."""
    calls, real = [], proposals.nms_batched

    def recorded(boxes, valid, thresh, max_out):
        calls.append((boxes.shape[0], boxes.shape[1], max_out))
        return real(boxes, valid, thresh, max_out)

    proposals.nms_batched = recorded

    def undo():
        proposals.nms_batched = real
    return calls, undo


def same_batch(a, b):
    return set(a) == set(b) and all(np.array_equal(np.asarray(a[k]),
                                                   np.asarray(b[k]))
                                    for k in a)


def pretrain_stage(dev):
    """Phases 17b-g: the reference's stages before lang2seg training, at
    full width (`flagship_config("pretrain")`, random weights from a
    seed). The raw REFER tree and a COCO instances.json are written to a
    temporary directory; coco_minus_refer drops the REFER val / test
    images; CocoDetectionLoader (flips on, M = 8) -> to_wire -> train_step:
    a warm-up step, one under the sync debug mode, three timed; the loader
    round trip; the pretrain weights into a `response` Trainer over the
    in-memory prepro of the same tree, one step. Returns the launch counts
    of the pretraining steps and of the response step."""
    cfg = flagship_config("pretrain")
    check(not cfg.model.use_language and cfg.data.max_gt_per_image == 8)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pretrain_") as tmp:
        coco, read = write_mini_refer(tmp, **PRETRAIN_TREE)
        minus = os.path.join(tmp, "coco_minus_refer", "instances.json")
        kept = make_coco_minus_refer(coco, [(tmp, "refcoco", "unc")], minus)
        with open(coco) as f:
            full = {im["id"] for im in json.load(f)["images"]}
        with open(minus) as f:
            left = {im["id"] for im in json.load(f)["images"]}
        held = {1000 + i for i, s in enumerate(PRETRAIN_TREE["splits"])
                if s != "train"}
        log(f"[pretrain] coco_minus_refer kept {kept} of {len(full)} images;"
            f" dropped {sorted(full - left)} (the val / test images "
            f"{sorted(held)})")
        check(full - left == held and kept == len(left),
              "coco_minus_refer did not drop exactly the val / test images")

        loader = CocoDetectionLoader(minus, tmp, cfg, use_flipped=True,
                                     seed=cfg.seed, read_image=read)
        t0 = time.perf_counter()
        state = create_train_state(cfg, device=dev, seed=0)
        model = state.model
        check(not any(k.startswith(("rnn_encoder.", "dynamic_fc",
                                    "response_fc."))
                      for k in model.state_dict()))
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        torch.cuda.synchronize()
        log(f"[pretrain] model and SGD built in "
            f"{time.perf_counter() - t0:.1f} s "
            f"({sum(p.numel() for p in model.state_dict().values())} "
            f"weights, {len(state.optimizer.param_groups)} groups, lr "
            f"{cfg.train.learning_rate})")

        host_ms, step_ms, steps, per_step, n_gt = [], [], [], [], []
        lanes, undo = record_nms_lanes()
        trained = ("nms", "fused_filter", "fused_filter_bwd")
        since = Launches()
        try:
            for i in range(5):
                t0 = time.perf_counter()
                batch = to_wire(cfg, loader.get_batch())
                host_ms.append((time.perf_counter() - t0) * 1e3)
                check(batch["gt_masks"].shape == (
                    2, 8, cfg.data.canvas_h, cfg.data.canvas_w // 8))
                n_gt.append(int(batch["gt_valid"].sum()))
                if i == 2:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                c0 = Launches()
                t0 = time.perf_counter()
                dev_batch = to_device(batch, dev)
                if i == 1:
                    losses, syncs = host_syncs(
                        lambda: train_step(state, dev_batch, gen))
                    _, control = host_syncs(
                        lambda: float(losses["total_loss"]))
                    log(f"[pretrain] step 2 under the sync debug mode: "
                        f"{len(syncs)} host synchronisations {syncs[:3]} "
                        f"(control, a loss read: {len(control)})")
                    check(control, "the sync debug mode did not report a "
                          "loss read")
                    check(not syncs, "the pretrain step synchronises with "
                          "the host")
                else:
                    losses = train_step(state, dev_batch, gen)
                torch.cuda.synchronize()
                if i >= 2:
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                per_step.append(c0.of(*trained))
                steps.append({k: float(v) for k, v in losses.items()})
        finally:
            undo()
        launched = since.of(*trained)
        runs["pretrain"] = dict(zip(trained, launched))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[pretrain] loader host ms a batch "
            f"{[round(x, 1) for x in host_ms]}; GT boxes a batch {n_gt}; "
            f"step ms {[round(x, 2) for x in step_ms]} (mean "
            f"{sum(step_ms) / len(step_ms):.2f}, upload to sync); peak device "
            f"memory {peak:.2f} GiB; launches per step (nms, gate, gate bwd) "
            f"{per_step}; NMS calls (lanes, boxes, max_out) {lanes}")
        for i, ls in enumerate(steps):
            log(f"[pretrain] step {i + 1} losses "
                f"{ {k: round(v, 4) for k, v in sorted(ls.items())} }")
            check(all(np.isfinite(v) for v in ls.values()),
                  f"non-finite loss at pretrain step {i + 1}")
            check("loss_mask" in ls and "loss_response" not in ls
                  and "loss_caption" not in ls, sorted(ls))
        check(all(c == (1, 0, 0) for c in per_step),
              "a pretrain step did not launch NMS once and the gate never")
        check(lanes == [PRETRAIN_NMS[:2] + PRETRAIN_NMS[4:]] * 5,
              f"the pretrain step's NMS ran at {lanes}")
        after = dict(model.named_parameters())
        frozen = [n for n, p in after.items() if not p.requires_grad]
        check(frozen and all(torch.equal(before[n], after[n])
                             for n in frozen), "a frozen parameter changed")
        moved = {}
        for grp in state.optimizer.param_groups:
            n_moved = sum(int(not torch.equal(before[n], p))
                          for n, p in zip(grp["names"], grp["params"]))
            moved[f"x{grp['lr_mult']:g} wd {grp['weight_decay']:g}"] = \
                f"{n_moved}/{len(grp['params'])}"
            check(n_moved > 0, f"SGD group {grp['lr_mult']} did not move")
        log(f"[pretrain] {len(frozen)} frozen parameters bit-identical; "
            f"moved per group {moved}")

        # (e) the loader's state_dict round trip draws the same next batch
        saved = loader.state_dict()
        want = loader.get_batch()
        other = CocoDetectionLoader(minus, tmp, cfg, seed=cfg.seed + 1,
                                    read_image=read)
        other.load_state_dict(saved)
        resumed = same_batch(other.get_batch(), want)
        log(f"[pretrain] loader resumed from its state_dict draws the same "
            f"batch: {resumed}")
        check(resumed, "the loader's state_dict round trip drew another "
              "batch")

        # (f, g) the recipe link: the prepro of the raw tree in memory (no
        # h5py), a `response` Trainer over it, initialized from the
        # pretrain weights, one step
        pre_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del state, model, before, after, gen
        t0 = time.perf_counter()
        info, labels = prepro_data(REFER(tmp), DEFAULT_MAX_LENGTH["refcoco"],
                                   count_threshold=0)
        t_prepro = (time.perf_counter() - t0) * 1e3
        rcfg = flagship_config()
        rcfg.train.images_per_batch, rcfg.train.expressions_per_batch = 2, 16
        rcfg.train.display = rcfg.train.summary_interval = 10 ** 9
        gt_loader = GtBatchLoader(info, labels, rcfg, seed=rcfg.seed,
                                  read_image=read)
        rcfg.model.vocab_size = rcfg.model.cap_vocab_size = \
            gt_loader.vocab_size
        trainer = Trainer(rcfg, gt_loader, device=dev, seed=0)
        skipped = trainer.load_pretrained(pre_sd)
        sd = trainer.state.model.state_dict()
        missing = skipped["missing"]
        taken = all(torch.equal(sd[k], v) for k, v in pre_sd.items())
        log(f"[pretrain] prepro in memory: {len(info['images'])} images, "
            f"{len(info['refs'])} refs, {len(labels)} sentences, vocabulary "
            f"{gt_loader.vocab_size}, in {t_prepro:.1f} ms; the response "
            f"model took {len(pre_sd)} pretrain tensors (all equal: {taken});"
            f" missing {len(missing)} (language), mismatched "
            f"{skipped['mismatched']}, unexpected {skipped['unexpected']}")
        check(taken and set(sd) - set(missing) == set(pre_sd),
              "a pretrain tensor was not taken as it is")
        check(missing and all(k.startswith(("rnn_encoder.", "dynamic_fc",
                                            "response_fc."))
                              for k in missing),
              f"non-language keys missing: {missing}")
        check(not skipped["mismatched"] and not skipped["unexpected"])
        since = Launches()
        t0 = time.perf_counter()
        rlosses = trainer.train(1)
        torch.cuda.synchronize()
        t_resp = (time.perf_counter() - t0) * 1e3
        rl = since.of(*trained)
        runs["recipe_link"] = dict(zip(trained, rl))
        log(f"[pretrain] response step on the pretrain weights and the "
            f"prepro'd batch: {t_resp:.1f} ms (first step, loader "
            f"included), launches {rl}, losses "
            f"{ {k: round(v, 4) for k, v in sorted(rlosses.items())} }")
        check(rl == (1, 1, 1), "the response step did not launch each "
              "kernel once")
        check(all(np.isfinite(v) for v in rlosses.values())
              and "loss_response" in rlosses)
        del trainer
    record["pretrain"] = {
        "kept_images": kept, "loader_host_ms": host_ms, "step_ms": step_ms,
        "peak_gib": peak, "launches_per_step": per_step, "nms_calls": lanes,
        "losses": steps, "moved_per_group": moved, "host_syncs": len(syncs),
        "loader_resumed": resumed, "prepro_ms": t_prepro,
        "recipe_missing": len(missing), "recipe_response_losses": rlosses,
        "recipe_response_ms": t_resp}
    return runs


# ------------------------------------------------------------ phases 19-22

ZOO_DECODERS = ("show_tell", "fc", "topdown", "show_attend_tell", "adaatt")


def attribute_head():
    """Phase 19: the attribute head at full width. Returns the launch
    counts of its training run."""
    cfg = flagship_config()
    m = cfg.model
    m.use_attribute_head, m.num_attributes = True, 50
    cfg.train.images_per_batch, cfg.train.expressions_per_batch = 2, 16
    with tempfile.TemporaryDirectory(prefix="chip_smoke_att_") as tmp:
        _, read = write_mini_refer(tmp, **PRETRAIN_TREE)
        att_json = write_attribute_file(tmp, m.num_attributes)
        info, labels = prepro_data(REFER(tmp), DEFAULT_MAX_LENGTH["refcoco"],
                                   count_threshold=0, att_json=att_json)
    loader = GtBatchLoader(info, labels, cfg, seed=cfg.seed, read_image=read)
    m.vocab_size = m.cap_vocab_size = loader.vocab_size
    check(len(loader.att_to_ix) == m.num_attributes,
          f"attribute vocabulary of {len(loader.att_to_ix)} words")
    # the Trainer's batches, without the loader's expr_uid (train_step
    # takes them as they are)
    batches = [{k: v for k, v in loader.get_batch("train").items()
                if k != "expr_uid"} for _ in range(4)]
    for b in batches:
        check(b["att_labels"].shape == (16, 50)
              and b["att_valid"].dtype == bool)
    n_valid = [int(b["att_valid"].sum()) for b in batches]
    log(f"[attributes] {len(info['refs'])} refs, {len(loader.att_to_ix)} "
        f"attribute words; valid expressions a batch {n_valid}")
    launches, trainer = train_full_width("train_att", cfg, batches)

    model = trainer.state.model
    score = attribute_scorer(model, device="cuda")
    seen, times = [], []

    def timed(images, boxes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = score(images, boxes)
        times.append((time.perf_counter() - t0) * 1e3)
        seen.append(out)
        return out
    results = {split: eval_attributes(loader, timed, split, max_refs=16)
               for split in ("train", "val", "testA")}
    scores = np.concatenate([x.reshape(-1) for x in seen])
    summary = {k: (r["n_refs"], {n: round(v, 4)
                                 for n, v in r["overall"].items()})
               for k, r in results.items()}
    log(f"[attributes] eval_attributes (refs, P / R / F1) {summary}; "
        f"{len(times)} images, ms an image {[round(t, 2) for t in times]}; "
        f"scores in [{scores.min():.4f}, {scores.max():.4f}]")
    check(len(seen) == len(times) > 0 and all(
        x.shape == (1, 16, 50) for x in seen))
    check(bool(np.isfinite(scores).all() and (scores >= 0).all()
               and (scores <= 1).all()), "attribute scores outside [0, 1]")
    for r in results.values():
        check(r["n_refs"] > 0)
        for v in r["overall"].values():
            check(v == -1.0 or 0.0 <= v <= 1.0, r["overall"])
    record["train_att"].update(
        attribute_eval={k: dict(r) for k, r in results.items()},
        attribute_ms_per_image=times)
    del trainer, model, score
    return launches


def comprehension():
    """Phase 20: comprehension over GT boxes and over detections at full
    width. Returns the gate's and NMS's launches by bucket."""
    cfg = flagship_config()
    info, labels, read = mini_refer_split(*FILE_SPLIT, seed=0)
    loader = GtBatchLoader(info, labels, cfg, seed=cfg.seed, read_image=read)
    cfg.model.vocab_size = cfg.model.cap_vocab_size = loader.vocab_size
    batches = [b for split in ("val", "testA")
               for b in loader.iter_test_batches(split, buckets=EVAL_BUCKETS)]
    check(sorted({b["labels"].shape[0] for b in batches})
          == list(EVAL_BUCKETS))
    ev = ComprehensionEvaluator(build_model(cfg, device="cuda", seed=0), cfg)
    per_image, scores, real = [], [], ev.score_boxes

    def counted(images, labels, boxes):
        c0 = Launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(images, labels, boxes)
        torch.cuda.synchronize()
        per_image.append((labels.shape[0], (time.perf_counter() - t0) * 1e3,
                          *c0.of("nms", "fused_filter")))
        scores.append(out)
        return out
    ev.score_boxes = counted
    ev.eval_split(batches[:1])                  # warm-up, not counted
    per_image.clear()
    scores.clear()
    since = Launches()
    gt_res = ev.eval_split(batches)
    gt_runs = list(per_image)
    n_valid = sum(int(b["sent_valid"].sum()) for b in batches)
    # detections in the reference's flat format: each image's GT boxes
    # jittered and 40 random boxes, none for the first images of buckets 8
    # and 32 (so that a 32 bucket image scores 32 x 32 candidates)
    r = np.random.RandomState(20)
    dets = []
    no_dets = {next(int(b["image_id"]) for b in batches
                    if b["labels"].shape[0] == e) for e in (8, 32)}
    for b in batches:
        if int(b["image_id"]) in no_dets:
            continue
        gt = b["gt_boxes"][b["sent_valid"], :4] / b["im_scale"]
        xy = r.uniform(0, 300, (40, 2))
        boxes = np.concatenate([gt + r.randn(*gt.shape) * 4.0,
                                np.concatenate([xy, xy + r.uniform(
                                    30, 200, (40, 2))], 1)])
        for box in boxes:
            x1, y1, x2, y2 = (float(v) for v in box)
            dets.append({"det_id": len(dets) + 1,
                         "image_id": int(b["image_id"]),
                         "box": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                         "category_id": 1, "category_name": "person",
                         "score": float(r.uniform(0.05, 1.0))})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dets_") as tmp:
        path = os.path.join(tmp, "dets.json")
        with open(path, "w") as f:
            json.dump({"dets": dets}, f)
        dets_loader = DetsLoader(path)
    dets_res = ev.eval_split_dets(batches, dets_loader, max_cands=32)
    launched = since.of("nms", "fused_filter", "fused_filter_bwd")
    skipped = sum(int(b["sent_valid"].sum()) for b in batches
                  if int(b["image_id"]) in no_dets)
    by_bucket = {}
    for e, ms, _, _ in per_image:
        by_bucket.setdefault(e, []).append(ms)
    log(f"[comprehension] over GT boxes {gt_res}; over detections "
        f"{dets_res} ({len(dets)} boxes, {len(no_dets)} images without); "
        f"(bucket, ms, nms, gate) an image "
        f"{[(e, round(ms, 2), n, g) for e, ms, n, g in per_image]}; "
        f"launches (nms, gate, gate bwd) {launched}")
    check(all(n == 0 and g == 1 for _, _, n, g in per_image),
          "a comprehension image did not launch the gate once and NMS never")
    check(launched == (0, len(per_image), 0))
    check(len(gt_runs) == len(batches)
          and len(per_image) == 2 * len(batches) - len(no_dets))
    check(all(bool(torch.isfinite(x).all()) for x in scores),
          "non-finite comprehension scores")
    check(gt_res["n"] == n_valid and 0.0 <= gt_res["comprehension_acc"] <= 1)
    check(dets_res["skipped_no_dets"] == skipped
          and dets_res["n"] == n_valid - skipped)
    record["comprehension"] = {
        "gt": gt_res, "dets": dets_res, "per_image": per_image,
        "ms_by_bucket": by_bucket}
    runs = {}
    for b in EVAL_BUCKETS:
        k = sum(1 for e, _, _, _ in per_image if e == b)
        runs[f"comprehension_{b}"] = {"nms": 0, "fused_filter": k}
    del ev
    return runs


def caption_side(cfg, feats):
    """Phase 21: (a) captioner pretraining of each zoo decoder on phase
    11's features, (b) phase 9's checks on `cycle_response` with the
    `topdown` decoder, (c) the caption metrics of att2in2's beam-10
    decodes over phase 12's val images. Returns (b)'s launches."""
    fc, att, seq, mask = feats
    zoo = {}
    for name in ZOO_DECODERS:
        zcfg = copy.deepcopy(cfg)
        zcfg.model.caption_model = name
        state = init_captioner_state(zcfg, device="cuda", seed=0)
        before = {k: v.detach().clone()
                  for k, v in state.captioner.state_dict().items()}
        losses, times = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = captioner_train_step(state, fc, att, seq, mask)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        after = state.captioner.state_dict()
        unmoved = sorted(k for k, v in before.items()
                         if torch.equal(v, after[k]))
        zoo[name] = {"losses": losses, "adam_step_ms": times,
                     "tensors": len(before), "unmoved": unmoved}
        log(f"[caption-zoo] {name}: {len(before)} tensors, losses "
            f"{[round(v, 4) for v in losses]}, Adam steps "
            f"{[round(t, 2) for t in times]} ms; unmoved {unmoved}")
        check(all(np.isfinite(v) for v in losses), f"{name}: non-finite loss")
        check(not unmoved, f"{name}: parameters did not move: {unmoved}")
        del state
    record["caption_zoo"] = zoo

    tcfg = copy.deepcopy(cfg)
    tcfg.model.caption_model = "topdown"
    launches, trainer = train_full_width("train_topdown", tcfg)
    del trainer

    info, labels, read = mini_refer_split(*FILE_SPLIT, seed=0)
    ccfg = flagship_config("cycle_response")
    loader = CycleBatchLoader(info, labels, ccfg, seed=ccfg.seed,
                              read_image=read)
    ccfg.model.vocab_size = ccfg.model.cap_vocab_size = loader.vocab_size
    model = build_model(ccfg, device="cuda", seed=0)
    eval_captions.score_caption_split(model, loader, "val", 10,
                                      max_images=1)          # warm-up
    n_images = len(loader.split_ix["val"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = eval_captions.score_caption_split(model, loader, "val", 10)
    ms = (time.perf_counter() - t0) * 1e3 / n_images
    log(f"[caption-metrics] att2in2 beam 10 over {n_images} val images: "
        f"{ {k: round(v, 4) for k, v in scores.items()} }; {ms:.1f} ms an "
        f"image (loader and metrics included)")
    check(list(scores) == ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                           "ROUGE_L", "CIDEr", "METEOR"], list(scores))
    check(all(np.isfinite(v) for v in scores.values()), scores)
    record["caption_metrics"] = {"scores": scores, "ms_per_image": ms,
                                 "images": n_images}
    del model
    return launches



# --------------------------------------------------------------- phase 27

# the shapes phase 27's main path must launch (the mix at 4 images a
# dispatch and the bucket-32 chunk): NMS over 4 x S lanes and the gate on
# 4 maps read by S expressions each, S = 8, 16 and 32
EVAL_MODE_SHAPES = ("nms_32", "nms_64", "nms_128", "fused_filter_4x8",
                    "fused_filter_4x16", "fused_filter_4x32")
# a chunk of the 32 bucket: 4 images of 20 to 32 valid sentences
BUCKET32_COUNTS = (20, 25, 29, 32)
# the modes whose pass phase 27 profiles (images a dispatch, extent crop,
# staged uploads); tools/profile_eval.py profiles all 8
EVAL_MODE_PROFILED = ((1, True, True), (4, True, True))


def eval_mode_kernels(dev, regs, launched, covered):
    """Each shape at which phase 27's main path launched NMS ("nms_<E>",
    E lanes) or the gate ("fused_filter_<N>x<S>": N maps read by S
    expressions each) and that no earlier `kernels` entry reports
    (`covered`: the entries' (path, counter) pairs): NMS at (E, 6000) ->
    300 bit for bit against its plain version on an RPN draw, the gate
    on N maps (one: the stride-0 map) to phase 4's tolerances; each timed
    beside its bound. Returns their `kernels` entries."""
    results = []
    for key in sorted(launched, key=lambda k: (k[0], len(k), k)):
        if ("eval_modes", key) in covered:
            continue
        kind, shape = key.rsplit("_", 1)
        if kind == "nms":
            e = int(shape)
            results.append(check_nms_shape(
                dev, e, 6000, 50 + e, 0.7, 300, (("eval_modes", key),),
                "eval-modes", key=f"eval_modes_{key}"))
            continue
        n, g = (int(x) for x in shape.split("x"))
        e = n * g
        if n == 1:
            conv, filt, rfilt = gate_inputs(e, 40, 64, 1024, 7, "broadcast",
                                            dev, seed=60 + e)[:3]
        else:
            gen = torch.Generator().manual_seed(40 + 100 * n + g)
            conv = (torch.randn((n, 40, 64, 1024), generator=gen)
                    * 2.0).to(dev, torch.bfloat16)
            filt = torch.tanh(torch.randn((e, 1024, 7),
                                          generator=gen)).to(dev)
            rfilt = torch.tanh(torch.randn((e, 7), generator=gen)).to(dev)
        results.append(check_gate_shape(
            dev, regs, conv, filt, rfilt, 1 if n == 1 else g, n,
            f"fused_filter_eval_{n}x{g}", (("eval_modes", key),),
            "eval-modes"))
    return results


def eval_modes(dev, regs, covered):
    """Phase 27: `tools/profile_eval.py`'s mix through
    `Evaluator.eval_split` in each mode (one image or 4 a dispatch, the
    extent crop on or off, staged uploads on or off), then one chunk of 4
    bucket-32 images; each checked pass with the launch counts set to 0
    before and read after, every dispatch launching NMS and the gate
    once, under the sync debug mode; then the kernels at each shape the
    passes launched them at that no earlier entry reports
    (`eval_mode_kernels`). Returns (kernels entries, launches by
    shape)."""
    t0 = time.perf_counter()
    cfg = profile_eval.eval_config()
    model = build_model(cfg, device="cuda", seed=0)
    # the rates come from the checked pass of each mode (passes=0)
    results = profile_eval.run_modes(model, cfg, profile_eval.eval_mix(cfg),
                                     passes=0, profiled=EVAL_MODE_PROFILED)
    t_modes = time.perf_counter() - t0
    big = [profile_eval.eval_batch(cfg, 100 + i, n, buckets=(32,))
           for i, n in enumerate(BUCKET32_COUNTS)]
    ev = Evaluator(model, cfg)
    ev.eval_split(big, images_per_dispatch=4)                 # warm-up
    b32 = profile_eval.checked_pass(ev, big, 4, True)
    check([d[:4] for d in b32["dispatches"]] == [(4, 32, 1, 1)]
          and tuple(b32["launches"]) == (1, 1) and not b32["host_syncs"],
          f"the bucket-32 chunk: {b32['dispatches']} {b32['launches']} "
          f"{b32['host_syncs'][:2]}")
    check(b32["state"][0] == sum(BUCKET32_COUNTS))
    log(f"[eval-modes] a chunk of 4 bucket-32 images (128 expressions): "
        f"{b32['dispatches'][0][4]:.2f} ms device span, peak "
        f"{b32['peak_gib']:.2f} GiB, h2d {b32['h2d_bytes'] / 2 ** 20:.1f} "
        f"MiB; {b32['summary']}")
    launched = collections.Counter()
    for r in list(results.values()) + [b32]:
        for n, s_, nms, gate, _ in r["dispatches"]:
            launched[f"nms_{n * s_}"] += nms
            launched[f"fused_filter_{n}x{s_}"] += gate
    check(set(EVAL_MODE_SHAPES) <= set(launched),
          f"phase 27 launched the kernels at {sorted(launched)}")
    del model, ev
    t1 = time.perf_counter()
    kernels = eval_mode_kernels(dev, regs, launched, covered)
    record["eval_modes"] = {"modes": results, "bucket32": b32,
                            "launches": dict(launched),
                            "seconds": time.perf_counter() - t0}
    log(f"[eval-modes] launches by shape {dict(launched)}; "
        f"{record['eval_modes']['seconds']:.1f} s in all, the modes "
        f"{t_modes:.1f} s, the kernels' checks "
        f"{time.perf_counter() - t1:.1f} s")
    return kernels, dict(launched)


# ------------------------------------------------------------ phases 23-26

# the JAX package computes ROI max pooling in plain XLA, no Pallas kernel
POOL_REPLACES = {"forward": "lang2seg_tpu/ops/roi_align.py:173",
                 "backward": "lang2seg_tpu/ops/roi_align.py:192"}


# the forward's kernels by the launch key's kernel field
# (`roi_pool_cuda.forward_kernel`)
POOL_KERNELS = {"slab": "roi_pool_fwd_smem_kernel",
                "few_rois": "roi_pool_fwd_band_kernel",
                "scan": "roi_pool_fwd_scan_kernel"}


def pool_registers():
    """ptxas's (registers a thread, stack frame, spill store and spill load
    bytes) of the bf16 ROI pool kernels with one-byte codes: each forward
    kernel with the argmax ("<kernel>+argmax") and without ("<kernel>"),
    and the backward ("backward")."""
    regs = kernel_registers(_build.library_path("roi_pool").with_name(
        "build.log"))

    def find(key):
        hits = [v for name, v in regs.items() if key in name]
        return list(hits[0]) if len(hits) == 1 else None

    out = {}
    for kernel, fn in POOL_KERNELS.items():
        for arg in (True, False):
            out[kernel + ("+argmax" if arg else "")] = find(
                f"{fn}<__nv_bfloat16, unsigned char, "
                f"{'true' if arg else 'false'}>")
    out["backward"] = find("roi_pool_bwd_smem_kernel<__nv_bfloat16, "
                           "unsigned char>")
    return out


def pool_keys(e, r, h, w, c, train, dev):
    """The launch keys (`roi_pool_cuda.shape_key`) of the forward and the
    backward of one bf16 shape, with the kernels the wrappers pick."""
    plan = roi_pool_cuda.slab_plan(h, w, c, torch.bfloat16, POOLED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kernel = roi_pool_cuda.forward_kernel(plan, e, r, w, POOLED, sms)[0]
    return (roi_pool_cuda.shape_key(e, r, POOLED, h, w, c, torch.bfloat16,
                                    train, kernel),
            roi_pool_cuda.shape_key(e, r, POOLED, h, w, c, torch.bfloat16,
                                    True, plan["backward"]["route"]))


def pool_entries(name, res, keys, regs, train):
    """The `kernels` entries of one checked and timed ROI pool shape:
    the forward's, and the backward's when it was timed, each with the
    registers of the kernel its launch key names. Each carries the shape
    key whose launches it reports (`pool_launches`)."""
    fwd = {"name": f"roi_pool_{name}", "route": "cuda",
           "source": "lang2seg_tpu_torch/csrc/roi_pool.cu",
           "replaces": POOL_REPLACES["forward"],
           "max_abs_err": res["forward_max_abs_err"], "ms": res["ms"],
           "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
           "bound_by": res["bound_by"], "library_ms": None,
           "kernel": POOL_KERNELS[keys[0][-1]],
           "registers": regs[keys[0][-1] + ("+argmax" if train else "")],
           "pool_key": ("fwd", keys[0])}
    if "bwd_ms" not in res:
        return [fwd]
    return [fwd, {
        "name": f"roi_pool_bwd_{name}", "route": "cuda",
        "source": "lang2seg_tpu_torch/csrc/roi_pool.cu",
        "replaces": POOL_REPLACES["backward"],
        "max_abs_err": res["bwd_max_abs_err"], "ms": res["bwd_ms"],
        "plain_ms": res["bwd_plain_ms"], "bound_ms": res["bwd_bound_ms"],
        "bound_by": res["bwd_bound_by"], "library_ms": None,
        "kernel": "roi_pool_bwd_smem_kernel",
        "registers": regs["backward"], "pool_key": ("bwd", keys[1])}]


def check_pool_shape_logged(name, e, r, h, w, c, maps, train, dev, regs,
                            reps, seed):
    """`profile_roi_pool.check_shape` with phase 23's checks and log line
    (the achieved GB/s and the slab plan too); returns the shape's
    `kernels` entries."""
    res = check_pool_shape(name, e, r, h, w, c, maps, train, dev, reps=reps,
                           seed=seed)
    plan = res["plan"]
    log(f"[roi-pool] {name} ({maps} maps, argmax {train}): forward equal "
        f"{res['forward_equal']}, decoded argmax equal "
        f"{res['argmax_equal']}, {res['empty_bins']} empty and "
        f"{res['rescanned_bins']} rescanned bins, {res['window_pixels']} "
        f"window pixels; kernel {res['ms']:.4f} ms "
        f"({res['gb_per_s']:.0f} GB/s; {res['oversize_ms']:.4f} ms with "
        f"the oversize ROI), plain {res['plain_ms']:.1f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}, {res['bytes']} B)"
        + (f"; backward {res['bwd_max_ulps']} bf16 ulp, kernel "
           f"{res['bwd_ms']:.4f} ms ({res['bwd_gb_per_s']:.0f} GB/s; "
           f"{res['bwd_oversize_ms']:.4f} ms with the oversize ROI), plain "
           f"{res['bwd_plain_ms']:.1f} ms, bound "
           f"{res['bwd_bound_ms']:.4f} ms" if "bwd_ms" in res else "")
        + f"; plan {plan['channels']} channels x {plan['slabs']} slabs, "
          f"forward {res['kernel']} kernel, {plan['forward']['route']} "
          f"({plan['forward']['smem']} B), backward "
          f"{plan['backward']['route']} ({plan['backward']['bands']} x "
          f"{plan['backward']['band_rows']} rows, "
          f"{plan['backward']['smem']} B), {plan['code']} codes")
    check(pool_checks_pass(res), f"ROI pool kernels differ from the plain "
          f"versions at {name}")
    record[f"roi_pool_{name}"] = res
    keys = pool_keys(e, r, h, w, c, train, dev)
    return pool_entries(name, res, keys, regs, train)


def check_roi_pool(dev):
    """Phase 23: the ROI pool kernels against their plain versions on the
    card at the main path's shapes (`tools/profile_roi_pool.py::SHAPES`:
    16 x 256 ROIs on (16, 40, 64, 512) and (16, 40, 64, 1024) bf16 maps
    gathered from 2 images, forward with its argmax and backward; 16 x
    300 ROIs on 16 distinct maps of each width, the forward without an
    argmax), with the edge ROIs (off the map, 1 x 1, empty bins, corners
    on .5 after scaling, windows of ties) and the oversize ROI (bins the
    backward rescans): the forward and the decoded argmax bit for bit,
    the backward within 1 bf16 ulp; then each kernel's device time beside
    its bound. A stride-0 map and an f32 map are checked as well, and the
    large-map routes (`LARGE_SHAPE`: the forward's global scan, the
    backward in bands, two-byte codes), checked and timed (no entries: no
    path of this run pools such maps)."""
    regs = pool_registers()
    log(f"[roi-pool] registers, stack, spill stores, spill loads: {regs}")
    kernels = []
    for shape in POOL_SHAPES:
        kernels += check_pool_shape_logged(*shape, dev, regs, reps=20,
                                           seed=40)
        check(record[f"roi_pool_{shape[0]}"]["empty_bins"] > 0
              and record[f"roi_pool_{shape[0]}"]["rescanned_bins"] > 0
              and record[f"roi_pool_{shape[0]}"]["kernel"] == "slab",
              f"no empty or rescanned bin, or not the slab kernel, at "
              f"{shape[0]}")
    for label, r, maps, dtype in (
            ("stride-0", 300, "broadcast", torch.bfloat16),
            ("f32", 256, "gathered", torch.float32)):
        res = compare_pool_shape(16, r, 40, 64, 512, maps, dev, train=True,
                                 seed=40, dtype=dtype)[0]
        log(f"[roi-pool] {label} map, 16 x {r} ROIs at C = 512: forward "
            f"equal {res['forward_equal']}, decoded argmax equal "
            f"{res['argmax_equal']}, backward "
            f"{res.get('bwd_max_ulps', res.get('bwd_rel_err'))}")
        check(pool_checks_pass(res), f"ROI pool kernels differ on a "
              f"{label} map")
        record[f"roi_pool_{label}"] = res
    res = check_pool_shape(*LARGE_POOL_SHAPE, dev, reps=10, seed=40)
    log(f"[roi-pool] {LARGE_POOL_SHAPE[0]} ({res['plan']['forward']['route']}"
        f" forward, {res['plan']['backward']['route']} backward, "
        f"{res['plan']['code']} codes): forward equal "
        f"{res['forward_equal']}, decoded argmax equal "
        f"{res['argmax_equal']}, backward {res['bwd_max_ulps']} bf16 ulp; "
        f"forward {res['ms']:.4f} ms, backward {res['bwd_ms']:.4f} ms")
    check(pool_checks_pass(res) and res["plan"]["forward"]["route"] == "scan"
          and res["plan"]["backward"]["route"] == "bands",
          "the ROI pool kernels' large-map routes")
    record["roi_pool_large"] = res
    for shape in POOL_SHAPES:
        name, e, r, h, w, c, maps, train = shape
        if c != 512:
            continue
        clocks = pool_phase_clocks(e, r, h, w, c, maps, train, dev, seed=40)
        log(f"[roi-pool] {name} phase clocks (cycles a CTA; span and CTA "
            f"us): {json.dumps(clocks)}")
        record[f"roi_pool_{name}"]["phase_clocks"] = clocks
    return kernels, regs


def pool_launches(runs, kernels, dev, regs):
    """Phase 23, after phases 24-26: each ROI pool entry's launches, those
    of the runs at exactly its shape; every other shape at which a run
    launched the kernel (the requests of 4 and 8 expressions, the mask
    crops, the demo's one expression) checked and timed on 16 distinct
    maps' layout, one entry each. Every launch on the 40 x 64 map ran a
    shared-memory kernel. Returns the new entries."""
    launched = {"fwd": collections.Counter(),
                "bwd": collections.Counter()}
    for run in runs.values():
        launched["fwd"].update(run.get("roi_pool_shapes", {}))
        launched["bwd"].update(run.get("roi_pool_bwd_shapes", {}))
    log(f"[roi-pool] main-path launches by (E, R, P, H, W, C, dtype, "
        f"argmax, kernel): forward {dict(launched['fwd'])}, backward "
        f"{dict(launched['bwd'])}")
    check(all(k[-1] in ("slab", "few_rois") for k in launched["fwd"]
              if k[3:5] == (40, 64))
          and all(k[-1] == "smem" for k in launched["bwd"]
                  if k[3:5] == (40, 64)),
          "a launch on the 40 x 64 map left the shared-memory kernels")
    for kr in kernels:
        kr["launches"] = launched[kr["pool_key"][0]].pop(kr["pool_key"][1],
                                                         0)
        check(kr["launches"] > 0, f"{kr['name']} was not launched on the "
              f"main path")
    new = []
    for key in sorted(launched["fwd"]):
        e, r, p, h, w, c, dtype, train, _ = key
        check(p == POOLED and dtype == "bfloat16",
              f"a ROI pool launch at {key}")
        name = (f"{'train' if train else 'serve'}_{e}x{r}_{h}x{w}x{c}")
        entries = check_pool_shape_logged(name, e, r, h, w, c, "distinct",
                                          train, dev, regs, reps=10, seed=41)
        for kr in entries:
            kr["launches"] = launched[kr["pool_key"][0]].pop(
                kr["pool_key"][1], 0)
        new += entries
    check(not launched["bwd"],
          f"backward launches with no forward entry: {launched['bwd']}")
    return new


def mobilenet_pool_config():
    """Phase 24's configuration: the flagship `response` model on
    MobileNetV1 (C4 512, a 1024-wide tail) with ROI max pooling."""
    cfg = flagship_config()
    cfg.model.backbone = "mobilenet_v1"
    cfg.model.c4_feat_dim = 512
    cfg.model.pooling_mode = "pool"
    return cfg




def mobilenet_pool():
    """Phase 24: MobileNetV1 + ROI max pooling at full width, random
    weights from a seed: phase 7's checks on a `Trainer` of 2 images x 16
    expressions (NMS, the gate and its backward, the ROI pool kernel and
    its backward once a step, no host sync, the BatchNorm buffers fixed,
    every SGD group moving), then phase 5's requests at E = 4, 8 and 16;
    then one ResNet-101 `response` step and one E = 16 request in pool
    mode, for the kernel at C = 1024. Returns the runs' launches."""
    cfg = mobilenet_pool_config()
    n_values = sum(int(np.prod(v)) for v in state_dict_shapes(cfg).values())
    log(f"[mobilenet] MobileNetV1 + pool: {n_values} values")
    record["mobilenet_values"] = n_values
    runs = {"train_mobilenet": train_full_width("train_mobilenet", cfg)[0]}
    check(len(record["train_mobilenet"]["moved_per_group"]) >= 3)
    runs["serve_mobilenet"] = serve_requests("serve_mobilenet", cfg)[0]
    # ResNet-101 in pool mode: the kernel at C = 1024
    rcfg = flagship_config()
    rcfg.model.pooling_mode = "pool"
    batch = to_wire(rcfg, synthetic_batch(rcfg, 2, 16, seed=0))
    trainer = Trainer(rcfg, FixedBatchLoader([batch]), device="cuda", seed=0)
    kernels = ("nms", "fused_filter", "fused_filter_bwd", "roi_pool",
               "roi_pool_bwd")
    since = Launches()
    t0 = time.perf_counter()
    losses = trainer.train(1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    step = since.of(*kernels)
    log(f"[resnet-pool] one ResNet-101 pool step {ms:.1f} ms (a first "
        f"step), launches {step}, losses "
        f"{ {k: round(v, 4) for k, v in sorted(losses.items())} }")
    check(step == (1, 1, 1, 1, 1) and all(np.isfinite(v)
                                          for v in losses.values()),
          "the ResNet-101 pool step")
    runs["train_resnet_pool"] = dict(zip(kernels, step),
                                     **since.pool_shapes())
    runs["serve_resnet_pool"] = serve_requests(
        "serve_resnet_pool", rcfg, sizes=((16, 3),),
        model=trainer.state.model)[0]
    record["train_resnet_pool"] = {"first_step_ms": ms, "launches": step,
                                   "losses": losses}
    del trainer
    return runs


def check_png(path, image=None):
    """A PNG the port wrote: the signature, an IHDR of the image's width,
    height, 8 bits and colour type (0 grey, 2 RGB), CRCs, and rows that
    inflate to `image` (default: whatever they decode to). Returns the
    image."""
    with open(path, "rb") as f:
        data = f.read()
    if image is None:
        image = decode_png(data)
    h, w = image.shape[:2]
    color = 0 if image.ndim == 2 else 2
    check(data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
          and data[16:26] == struct.pack(">IIBB", w, h, 8, color),
          f"{path}: signature or IHDR")
    check(np.array_equal(decode_png(data), image),
          f"{path}: the rows do not inflate to the image")
    return image


def demo_and_dumps(dev):
    """Phase 26: `cli.demo.main` on the synthetic fixture on the card with
    `--variant response` (ResNet-101-C4, crop), then with phase 24's
    overrides (MobileNetV1, pool); each PNG checked against the image it
    holds, and a warm request timed through `cli.demo.annotate`. Then one
    full-width `Trainer` validation with `debug_save_dir`. Returns the
    pool demo's launches."""
    out_dir = os.path.join(OUT, "demo")
    os.makedirs(out_dir, exist_ok=True)
    runs = {}
    pool_sets = ["model.backbone", "mobilenet_v1", "model.c4_feat_dim", "512",
                 "model.pooling_mode", "pool"]
    for tag, sets in (("crop", []), ("pool", pool_sets)):
        out = os.path.join(out_dir, f"demo_{tag}.png")
        since = Launches()
        t0 = time.perf_counter()
        res = cli_demo.main(["--variant", "response", "--out", out,
                             "--expression", "the man on the left"]
                            + (["--set", *sets] if sets else []))
        torch.cuda.synchronize()
        ms_main = (time.perf_counter() - t0) * 1e3
        launched = since.of("nms", "fused_filter", "roi_pool")
        shapes = since.pool_shapes()
        check(launched[:2] == (1, 1) and launched[2] == (2 if sets else 0),
              f"the {tag} demo launched {launched}")
        check_png(out, res["image"])
        resp = check_png(res["response"])
        check(resp.shape == (40, 64), f"response PNG {resp.shape}")
        check(res["image"].shape == (480, 640, 3)
              and 1 <= res["cls"] <= 80
              and bool(np.isfinite(res["box"]).all()), f"{tag} demo output")
        # a warm request on the same weights and image
        cfg = apply_variant(load_config(None, sets), "response")
        model = build_model(cfg, device="cuda", seed=cfg.seed)
        labels = np.zeros((1, cfg.data.max_len), np.int64)
        labels[0, :5] = [cli_demo.stable_token(w, cfg.model.vocab_size)
                         for w in "the man on the left".split()]
        im = cli_demo.synthetic_image()
        cli_demo.annotate(model, cfg, im, labels, out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = cli_demo.annotate(model, cfg, im, labels, out)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(again["cls"] == res["cls"]
              and np.abs(again["box"] - res["box"]).max() <= 0.5,
              f"the {tag} demo request is not repeatable")
        del model
        log(f"[demo] {tag}: class {res['cls']}, box "
            f"{np.round(res['box'], 1).tolist()}, launches {launched}; "
            f"cli.demo.main {ms_main:.1f} ms (weights drawn on the host "
            f"included), a warm request {ms:.1f} ms")
        record[f"demo_{tag}"] = {"cls": res["cls"],
                                 "box": res["box"].tolist(),
                                 "main_ms": ms_main, "request_ms": ms,
                                 "launches": launched}
        if sets:
            runs["demo_pool"] = {"roi_pool": launched[2], **shapes}
    # one full-width validation with the debug dumps
    cfg = flagship_config()
    cfg.train.summary_interval = 1
    with tempfile.TemporaryDirectory() as tmp:
        cfg.train.debug_save_dir = os.path.join(tmp, "dbg")
        batches = [to_wire(cfg, synthetic_batch(cfg, 2, 16, seed=s))
                   for s in (0, 1)]
        trainer = Trainer(cfg, FixedBatchLoader(batches[:1]),
                          os.path.join(tmp, "out"),
                          val_loader=FixedBatchLoader(batches[1:]),
                          device="cuda", seed=0)
        t0 = time.perf_counter()
        trainer.train(1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        resp = os.path.join(tmp, "dbg", "response", "iter1_0.png")
        chans = sorted(os.listdir(os.path.join(tmp, "dbg", "net_conv")))
        check(os.path.exists(resp) and len(chans) == 5
              and all(c.startswith("iter1_0_") for c in chans),
              f"debug dumps {chans}")
        img = check_png(resp)
        check(img.shape == (40, 64) and img.max() > img.min(),
              "the response dump is flat")
        log(f"[debug-dump] one step with a validation and its dumps "
            f"{ms:.1f} ms; {chans}")
        record["debug_dump"] = {"step_with_val_ms": ms, "channels": chans}
        del trainer
    return runs


# ------------------------------------------------------------ phase 28

def same_train_states(a, b):
    """(parameters and buffers, momentum buffers) of two train states
    equal bit for bit."""
    pa, pb = a.model.state_dict(), b.model.state_dict()
    params = all(torch.equal(v, pb[k]) for k, v in pa.items())
    ma = [a.optimizer.state[p]["momentum_buffer"]
          for g in a.optimizer.param_groups for p in g["params"]]
    mb = [b.optimizer.state[p]["momentum_buffer"]
          for g in b.optimizer.param_groups for p in g["params"]]
    return params, len(ma) == len(mb) and all(
        torch.equal(x, y) for x, y in zip(ma, mb))


def profiled_window(fn):
    """fn() under torch.profiler (the device only): (the host window in
    ms, the device's busy ms, its idle share of the window, the hand
    kernels' runs counted by name in the trace)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    busy = profile_eval.device_busy(prof)["busy_ms"]
    return window, busy, 1.0 - busy / window, \
        profile_eval.kernel_launches(prof)


def timed_window(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_sgd_on_card(state):
    """The port's SGD on the card (the LR read from device tensors,
    `p.addcmul_(buf, -lr)`) against torch SGD's foreach step with the LR
    as a float, bit for bit: 3 steps of random gradients on copies of
    `state`'s trainable parameters, across an LR boundary."""
    cfg = copy.deepcopy(state.model.cfg)
    cfg.train.stepsize = (1,)
    groups = [[p.detach().clone() for p in g["params"]]
              for g in state.optimizer.param_groups]
    twins = [[p.clone() for p in grp] for grp in groups]

    def opt_of(cls, params, **kw):
        return cls([{"params": ps, "lr_mult": g["lr_mult"],
                     "weight_decay": g["weight_decay"]}
                    for ps, g in zip(params, state.optimizer.param_groups)],
                   lr=cfg.train.learning_rate, momentum=cfg.train.momentum,
                   **kw)
    ours = opt_of(SGD, groups)
    ref = opt_of(torch.optim.SGD, twins, foreach=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    for step in range(3):
        for a, b in zip(sum(groups, []), sum(twins, [])):
            a.grad = torch.randn(a.shape, generator=g, device="cuda")
            b.grad = a.grad.clone()
        for opt in (ours, ref):
            set_lr(opt, cfg, step)
            opt.step()
    same = all(torch.equal(a, b) for a, b in zip(sum(groups, []),
                                                 sum(twins, [])))
    log(f"[sgd] the port's SGD (device LR) against torch SGD (foreach, "
        f"float LR), 3 steps over {len(sum(groups, []))} tensors across an "
        f"LR boundary: bit-identical={same}")
    check(same, "the port's SGD differs from torch SGD on the card")
    return same


def graph_vs_eager(path, cfg, k=4, dispatches=3, decay_at=6, num_expr=16,
                   check_sgd=False):
    """Phase 28 for one configuration: K steps a dispatch for `dispatches`
    dispatches through `make_multi_train_step` (the warm step, the capture
    and the replays) against as many eager `train_step`s from the same
    weights, batches (4 synthetic ones of 2 images x `num_expr`
    expressions in turn) and generator seed, with an LR decay after step
    `decay_at`: every parameter, momentum buffer, the generator's state
    and every step's losses bit for bit. The launch counters count the
    kernels the card ran: the first dispatch's warm step and K - 1
    replays a pass each (the capture none); over the profiled dispatches,
    each kernel's count equals its runs traced by name, K a dispatch.
    Times: eager ms a step over steps K + 1 .. 2K and graphed over
    dispatch 2 (each a window ending in a sync), the capture's s; the idle
    share of the remaining eager steps and of the remaining dispatches
    under torch.profiler; the graphed run's peak memory. With
    `check_sgd`, first `check_sgd_on_card` on the model's groups. Returns
    the graphed run's launches (the ROI pool's by shape)."""
    cfg = copy.deepcopy(cfg)
    cfg.train.stepsize = (decay_at,)
    n = k * dispatches
    host = [to_wire(cfg, synthetic_batch(cfg, 2, num_expr, seed=s))
            for s in range(4)]
    seq = [host[i % 4] for i in range(n)]
    eager = create_train_state(cfg, "cuda", seed=0)
    graphed = create_train_state(cfg, "cuda",
                                 state_dict=eager.model.state_dict())
    if check_sgd:
        record["sgd_on_card"] = check_sgd_on_card(eager)
    ge = torch.Generator(device="cuda").manual_seed(cfg.seed)
    gg = torch.Generator(device="cuda").manual_seed(cfg.seed)
    singles = [to_device(b, "cuda") for b in seq]
    stacked = [to_device(stack_batches(seq[d * k:(d + 1) * k]), "cuda")
               for d in range(dispatches)]
    want = []

    def eager_steps(lo, hi):
        for j in range(lo, hi):
            want.append(train_step(eager, singles[j], ge))
    check(dispatches >= 3, "phase 28 times dispatch 2 and profiles 3")
    eager_steps(0, k)
    eager_ms = timed_window(lambda: eager_steps(k, 2 * k)) / k
    _, eager_busy, eager_idle, _ = profiled_window(
        lambda: eager_steps(2 * k, n))
    eager_busy /= n - 2 * k
    multi = make_multi_train_step(graphed, gg)
    got = []
    keys = tuple(COUNTERS)
    since = Launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first_ms = timed_window(lambda: got.append(multi(stacked[0])))
    first = dict(zip(keys, since.of(*keys)))
    graph_ms = timed_window(lambda: got.append(multi(stacked[1]))) / k
    profiled = Launches()
    _, graph_busy, graph_idle, traced = profiled_window(
        lambda: [got.append(multi(x)) for x in stacked[2:]])
    counted = dict(zip(keys, profiled.of(*keys)))
    graph_busy /= k * (dispatches - 2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pool = cfg.model.pooling_mode == "pool"
    want_step = dict(zip(keys[:7], (1, 1, 1) + (
        (1, 1, 0, 0) if pool else (0, 0, 1, 1))))
    replays = k * (dispatches - 2)
    check(all(first[key] == k * c for key, c in want_step.items()),
          f"[{path}] the first dispatch (a warm step, {k - 1} replays) "
          f"launched {first}")
    check(all(traced[key] == replays * c for key, c in want_step.items()),
          f"[{path}] the trace of {replays} replays ran the kernels "
          f"{traced} times")
    check(counted == {key: traced[key] for key in keys},
          f"[{path}] the counters counted {counted} over the profiled "
          f"dispatches, their trace ran {traced}")
    shapes = since.pool_shapes()
    if pool:
        for counter in shapes:
            check(len(shapes[counter]) == 1,
                  f"[{path}] ROI pool launches at {dict(shapes[counter])}")
    runs = dict(zip(keys, since.of(*keys)), **shapes)
    params, momentum = same_train_states(eager, graphed)
    gen = torch.equal(ge.get_state(), gg.get_state())
    loss_bits = all(torch.equal(got[j // k][key][j % k], want[j][key])
                    for j in range(n) for key in want[j])
    lrs = [g["lr"] for g in graphed.optimizer.param_groups]
    decayed = lrs == [g["lr"] for g in eager.optimizer.param_groups] and \
        abs(lrs[0] - cfg.train.learning_rate * cfg.train.gamma) <= \
        1e-12 * cfg.train.learning_rate
    finite = all(bool(torch.isfinite(v).all()) for d in got
                 for v in d.values())
    log(f"[{path}] {dispatches} dispatches of K = {k} (LR decay after step "
        f"{decay_at}) against {n} eager steps: parameters bit-identical="
        f"{params}, momentum={momentum}, generator={gen}, losses={loss_bits}, "
        f"LR decayed={decayed}, finite={finite}")
    check(params and momentum and gen and loss_bits and decayed and finite,
          f"[{path}] the graphed steps differ from the eager steps")
    entry = {"k": k, "dispatches": dispatches, "decay_at": decay_at,
             "eager_ms": eager_ms, "graphed_ms": graph_ms,
             "first_dispatch_ms": first_ms, "capture_s": multi.capture_s,
             "eager_busy_ms": eager_busy, "graphed_busy_ms": graph_busy,
             "eager_idle": eager_idle, "graphed_idle": graph_idle,
             "peak_gib": peak, "first_dispatch_launches": first,
             "traced_launches": traced, "counted_launches": counted,
             "traced_replays": replays,
             "losses": [{key: float(v) for key, v in w.items()}
                        for w in want]}
    log(f"[{path}] eager {eager_ms:.2f} ms a step (device busy "
        f"{eager_busy:.2f} ms, idle {100 * eager_idle:.1f}%), graphed "
        f"{graph_ms:.2f} ms a step (busy {graph_busy:.2f} ms, idle "
        f"{100 * graph_idle:.1f}%); first dispatch {first_ms:.1f} ms "
        f"(capture {multi.capture_s:.2f} s); peak {peak:.2f} GiB; kernel "
        f"runs traced in {replays} replays {traced}")
    record[path] = entry
    del eager, graphed, multi, singles, stacked
    return runs


def graphed_steps():
    """Phase 28: the train step as a CUDA graph, for `response` and
    `cycle_response` at full width (3 dispatches of K = 4) and MobileNetV1
    + pool (3 dispatches of K = 2); the port's SGD against torch's on the
    card first."""
    runs = {"graph_response": graph_vs_eager("graph_response",
                                             flagship_config(),
                                             check_sgd=True),
            "graph_cycle": graph_vs_eager(
                "graph_cycle", flagship_config("cycle_response"))}
    runs["graph_mobilenet"] = graph_vs_eager(
        "graph_mobilenet", mobilenet_pool_config(), k=2, dispatches=3,
        decay_at=3)
    return runs


# ------------------------------------------------------------ phase 29

def uid_batches(cfg, n, blocks=1):
    """n batches of `blocks` blocks of 2 images x 16 expressions with
    stable uids (4 synthetic draws in turn), in the wire formats."""
    out = []
    for i in range(n):
        parts = []
        for r in range(blocks):
            b = to_wire(cfg, synthetic_batch(cfg, 2, 16,
                                             seed=(i % 4) * blocks + r))
            b["expr_uid"] = np.arange(16, dtype=np.int32) + 16 * (
                (i % 4) * blocks + r)
            parts.append(b)
        out.append({key: np.concatenate([p[key] for p in parts])
                    for key in parts[0]})
    return out


def data_parallel_world1():
    """Phase 29: data parallel at world size 1 over NCCL (a file:// rendezvous
    in a temporary directory): `make_sharded_train_step` against a
    single-device `train_step` on the same batch with expr_uid and the same
    generators, bit for bit; then `make_sharded_multi_step` (K = 4, the
    all-reduce captured in the graph), two dispatches, against 8 eager
    sharded steps, bit for bit. The counters count the sharded step, the
    warm step and the replays (the capture nothing); the second dispatch
    runs under torch.profiler, and each kernel's count over it equals its
    runs traced by name. Returns the graphed run's launches."""
    cfg = flagship_config()
    batches = [to_device(b, "cuda") for b in uid_batches(cfg, 9)]
    with tempfile.TemporaryDirectory() as tmp:
        mesh = initialize_multihost(f"file://{tmp}/pg", 1, 0, device="cuda")
        try:
            check(mesh.backend == "nccl" and mesh.size == 1)
            single = create_train_state(cfg, "cuda", seed=0)
            sd = single.model.state_dict()
            eager = create_train_state(cfg, "cuda", state_dict=sd)
            graphed = create_train_state(cfg, "cuda", state_dict=sd)
            gens = {name: (dropout_generator(cfg.seed, 0, "cuda"),
                           sampling_generator(cfg.seed, "cuda"))
                    for name in ("single", "eager", "graphed")}
            for st in (eager, graphed):
                sync_replicas(st.model, mesh)
            ls = train_step(single, batches[0], gens["single"][0], None,
                            gens["single"][1])
            step_e = make_sharded_train_step(eager, mesh, *gens["eager"])
            le = [step_e(batches[0])]
            params, momentum = same_train_states(single, eager)
            losses = all(torch.equal(ls[key], le[0][key]) for key in ls)
            log(f"[dp-world1] sharded step against the single-device step "
                f"(expr_uid draws): parameters bit-identical={params}, "
                f"momentum={momentum}, losses={losses}")
            check(params and momentum and losses,
                  "the world-1 sharded step differs from the single step")
            del single
            le += [step_e(b) for b in batches[1:]]
            keys = ("nms", "fused_filter", "fused_filter_bwd", "roi_crop",
                    "roi_crop_bwd")
            since = Launches()
            step_g = make_sharded_train_step(graphed, mesh, *gens["graphed"])
            multi = make_sharded_multi_step(graphed, mesh, *gens["graphed"])
            check(multi.graphed, "the NCCL multi-step is not graphed")
            lg = [step_g(batches[0])]

            def dispatch(d):
                stacked = {key: torch.stack([b[key] for b in
                                             batches[1 + 4 * d:5 + 4 * d]])
                           for key in batches[0]}
                out = multi(stacked)
                lg.extend({key: v[j] for key, v in out.items()}
                          for j in range(4))
            dispatch(0)
            first = dict(zip(keys, since.of(*keys)))
            profiled = Launches()
            *_, traced = profiled_window(lambda: dispatch(1))
            counted = dict(zip(COUNTERS, profiled.of(*COUNTERS)))
            params, momentum = same_train_states(eager, graphed)
            losses = all(torch.equal(a[key], b[key])
                         for a, b in zip(le, lg) for key in a)
            gen = all(torch.equal(a.get_state(), b.get_state()) for a, b in
                      zip(gens["eager"], gens["graphed"]))
            launches = dict(zip(keys, since.of(*keys)))
            log(f"[dp-world1] a sharded step and 2 graphed dispatches of K = "
                f"4 (the NCCL all-reduce captured) against 9 eager sharded "
                f"steps: parameters bit-identical={params}, momentum="
                f"{momentum}, losses={losses}, generators={gen}; capture "
                f"{multi.capture_s:.2f} s; launches of the sharded step and "
                f"dispatch 1 {first}, counted in dispatch 2 {counted}, "
                f"traced there {traced}")
            check(params and momentum and losses and gen,
                  "the graphed NCCL multi-step differs from eager steps")
            check(first == {key: 5 for key in keys},
                  f"the sharded step, the warm step and 3 replays launched "
                  f"{first}")
            check(all(traced[key] == 4 for key in keys),
                  f"the trace of dispatch 2 ran the kernels {traced} times")
            check(counted == {key: traced[key] for key in COUNTERS},
                  f"the counters counted {counted} over dispatch 2, its "
                  f"trace ran {traced}")
            record["dp_world1"] = {"capture_s": multi.capture_s,
                                   "first_launches": first,
                                   "counted_launches": counted,
                                   "traced_launches": traced}
            del eager, graphed, multi
        finally:
            dist.destroy_process_group()
    return launches


# ------------------------------------------------------------ phase 30

DP_WORLD = 2


def dp_eval_batches(cfg):
    """Phase 12's mini split (in memory): the val and testA images at the
    sentence buckets."""
    info, labels, read = mini_refer_split(*FILE_SPLIT, seed=3)
    loader = GtBatchLoader(info, labels, cfg, seed=3, read_image=read)
    return [b for split in ("val", "testA")
            for b in loader.iter_test_batches(split, buckets=EVAL_BUCKETS)]


def dp_rank_worker(rank, root):
    """One rank of phase 30 (`python3 chip_smoke.py --dp-rank R DIR`): the
    gloo process group through DIR, the phase's weights and batch from
    DIR on the card; one sharded step on block R (gloo all-reduces the
    card's tensors through the host), the ranks' weights held equal after
    it, then eval_split_mesh over the mini split. Writes DIR/out<R>.pt,
    with the step's launches and the rank's launch counts as a record."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    payload = torch.load(os.path.join(root, "payload.pt"), weights_only=False)
    cfg = payload["cfg"]
    mesh = initialize_multihost(f"file://{root}/pg", DP_WORLD, rank,
                                device="cuda", backend="gloo",
                                timeout_s=600)
    try:
        state = create_train_state(cfg, "cuda",
                                   state_dict=payload["weights"])
        sync_replicas(state.model, mesh)
        gen = dropout_generator(cfg.seed, rank, "cuda")
        sgen = sampling_generator(cfg.seed, "cuda")
        step = make_sharded_train_step(state, mesh, gen, sgen)
        block = to_device(shard_batch(payload["batch"], DP_WORLD, rank),
                          "cuda")
        since = Launches()
        losses = step(block)
        torch.cuda.synchronize()
        launches = since.of("nms", "fused_filter", "fused_filter_bwd",
                            "roi_crop", "roi_crop_bwd")
        sync_replicas(state.model, mesh)      # every rank holds rank 0's
        ev = Evaluator(state.model, cfg, device="cuda")
        summary = ev.eval_split_mesh(payload["eval"], mesh)
        out = {"losses": {k: v.cpu() for k, v in losses.items()},
               "launches": launches, "summary": summary,
               "counts": since.record(),
               "gen": gen.get_state(), "sampling": sgen.get_state()}
        if rank == 0:
            opt = state.optimizer
            out["params"] = {k: v.cpu() for k, v in
                             state.model.state_dict().items()}
            out["momentum"] = [opt.state[p]["momentum_buffer"].cpu()
                               for g in opt.param_groups
                               for p in g["params"]]
        torch.save(out, os.path.join(root, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def data_parallel_two_ranks():
    """Phase 30: two ranks on the one card over gloo (NCCL refuses two
    ranks on one card: gloo is this test's configuration), two processes
    of this script with CUDA tensors: one sharded step on a batch of two
    blocks (2 images x 16 expressions each, with expr_uid) against the
    one-process shardwise oracle on the card (each block's gradients in
    turn, averaged, one update): parameters, momentum and losses bit for
    bit; then `eval_split_mesh` over the mini split against one process's
    `eval_split`, exactly. The ranks' launch counts join this process's.
    Returns the ranks' launches."""
    cfg = flagship_config()
    batch = uid_batches(cfg, 1, blocks=DP_WORLD)[0]
    oracle = create_train_state(cfg, "cuda", seed=0)
    weights = {k: v.cpu() for k, v in oracle.model.state_dict().items()}
    evals = dp_eval_batches(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"cfg": cfg, "weights": weights, "batch": batch,
                    "eval": evals}, os.path.join(tmp, "payload.pt"))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--dp-rank", str(r), tmp])
                 for r in range(DP_WORLD)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(codes == [0] * DP_WORLD, f"the gloo ranks exited {codes}")
        outs = [torch.load(os.path.join(tmp, f"out{r}.pt"),
                           weights_only=False) for r in range(DP_WORLD)]
        ranks_s = time.perf_counter() - t0
    gens = [dropout_generator(cfg.seed, r, "cuda") for r in range(DP_WORLD)]
    sgen = sampling_generator(cfg.seed, "cuda")
    want = shardwise_step(oracle, batch, gens, sgen)
    sd = oracle.model.state_dict()
    params = all(torch.equal(v.cuda(), sd[k])
                 for k, v in outs[0]["params"].items())
    mom = [oracle.optimizer.state[p]["momentum_buffer"]
           for g in oracle.optimizer.param_groups for p in g["params"]]
    momentum = all(torch.equal(a.cuda(), b)
                   for a, b in zip(outs[0]["momentum"], mom))
    losses = all(torch.equal(o["losses"][k].cuda(), v)
                 for o in outs for k, v in want.items())
    gen = all(torch.equal(o["gen"], g.get_state()) and
              torch.equal(o["sampling"], sgen.get_state())
              for o, g in zip(outs, gens))
    log(f"[dp-gloo] {DP_WORLD} ranks on one card (gloo, {ranks_s:.1f} s "
        f"with the processes' start): the sharded step against the "
        f"shardwise oracle: parameters bit-identical={params}, momentum="
        f"{momentum}, losses={losses}, generators={gen}; launches "
        f"{[o['launches'] for o in outs]}")
    check(params and momentum and losses and gen,
          "the two-rank step differs from the shardwise oracle")
    check(all(o["launches"] == (1, 1, 1, 1, 1) for o in outs),
          "a rank's step did not launch each kernel once")
    for o in outs:
        trace.add(o["counts"])
    del oracle
    model = build_model(cfg, device="cuda", state_dict=outs[0]["params"])
    acc = SegEvalAccumulator()
    ref = Evaluator(model, cfg, device="cuda").eval_split(evals, acc=acc)
    same = all(o["summary"] == ref for o in outs)
    log(f"[dp-gloo] eval_split_mesh over {len(evals)} images (buckets "
        f"{EVAL_BUCKETS}) against eval_split: equal={same}, {ref}")
    check(same and acc.num_sent > 0,
          "eval_split_mesh differs from eval_split")
    record["dp_gloo"] = {"ranks_s": ranks_s, "summary": ref,
                         "launches": [o["launches"] for o in outs]}
    del model
    return {"nms": sum(o["launches"][0] for o in outs),
            "fused_filter": sum(o["launches"][1] for o in outs),
            "fused_filter_bwd": sum(o["launches"][2] for o in outs)}


# ------------------------------------------------------------ phase 31

# the JAX package computes the crop in plain XLA (two einsums, and their
# transposes for the gradient), no Pallas kernel
CROP_REPLACES = "lang2seg_tpu/ops/roi_align.py:80"


def crop_registers():
    """ptxas's (registers a thread, stack frame, spill store and spill load
    bytes) of the crop kernels, by (side, dtype) (the backward's instance
    of 4 pixels a warp)."""
    regs = kernel_registers(_build.library_path("roi_crop").with_name(
        "build.log"))
    out = {}
    for side in ("fwd", "bwd"):
        for dtype, t in (("bfloat16", "__nv_bfloat16"), ("float32", "float")):
            kernel = f"roi_crop_{side}_kernel<{t}" + (
                ">" if side == "fwd" else ", 4>")
            hits = [v for name, v in regs.items() if kernel in name]
            out[side, dtype] = list(hits[0]) if len(hits) == 1 else None
    return out


def check_crop_shape_logged(name, e, r, h, w, c, maps, train, dev, reps,
                            dtype=torch.bfloat16, s=7):
    """`profile_crop.check_shape` with phase 31's checks and log line;
    returns its numbers."""
    res = profile_crop.check_shape(name, e, r, h, w, c, maps, train, dev,
                                   reps=reps, seed=31, dtype=dtype, s=s)
    errs = {k: v for k, v in res.items() if k.startswith(
        ("forward_", "bwd_repeat", "bwd_plain", "bwd_einsum"))}
    log(f"[roi-crop] {name} ({maps} maps): {errs}; forward {res['ms']:.4f} "
        f"ms ({res['gb_per_s']:.0f} GB/s), plain {res['plain_ms']:.2f} ms, "
        f"grid_sample {res['library_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']})"
        + (f"; backward {res['bwd_ms']:.4f} ms ({res['bwd_gb_per_s']:.0f} "
           f"GB/s), plain {res['bwd_plain_ms']:.1f} ms, einsum autograd "
           f"{res['bwd_einsum_ms']:.2f} ms, grid_sample "
           f"{res['bwd_library_ms']:.3f} ms, bound "
           f"{res['bwd_bound_ms']:.4f} ms; plan {res['band_plan']}"
           if train else ""))
    check(profile_crop.checks_pass(res), f"the ROI crop kernels differ from "
          f"the plain versions at {name}")
    record[f"roi_crop_{name}"] = res
    return res


def top_request_16():
    """Test mode 'top' at E = 16: one full-width request of 16 expressions
    through `Inference.predict` with the top 5000 proposals an expression
    (R = 5000; the einsum pair's intermediate alone would be 46 GB), after
    a warm-up request of 2; its ms, peak memory, and one crop launch at (16,
    5000). Returns the request's numbers."""
    cfg = flagship_config()
    cfg.test.mode = "top"
    model = build_model(cfg, device="cuda", seed=0)
    inf = Inference(model, cfg)
    warm = synthetic_eval_request(cfg, 2, seed=9, im_scale=1.6)
    inf.predict(warm["images"], warm["im_hw"], warm["labels"])
    b = synthetic_eval_request(cfg, 16, seed=10, im_scale=1.6)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    since = Launches()
    t0 = time.perf_counter()
    out = inf.predict(b["images"], b["im_hw"], b["labels"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    r = cfg.test.rpn_top_n
    launched = since.of("nms", "roi_crop")
    key = roi_crop_cuda.shape_key(16, r, cfg.model.pooling_size, 40, 64,
                                  cfg.model.c4_feat_dim, model.compute_dtype)
    seen = since.by_shape("roi_crop")
    finite = all(bool(torch.isfinite(out[k].float()).all())
                 for k in ("rois", "cls_prob", "bbox_pred"))
    log(f"[roi-crop] test mode 'top' at E = 16 (R = {r}): predict "
        f"{ms:.1f} ms, peak {peak:.2f} GiB; launches (nms, crop) "
        f"{launched} at {dict(seen)}; outputs finite {finite}")
    check(tuple(out["cls_prob"].shape) == (16, r, cfg.model.num_classes)
          and bool(out["roi_valid"].all()) and finite,
          "the 'top' request at E = 16")
    check(launched == (0, 1) and seen == {key: 1},
          "the 'top' request at E = 16 did not crop once at (16, 5000)")
    del model, inf, out
    torch.cuda.empty_cache()
    return {"predict_ms": ms, "peak_gib": peak, "rois": r,
            "launches": launched}


def check_crop(dev):
    """Phase 31: the ROI crop kernels (`csrc/roi_crop.cu`) against their
    plain versions at `profile_crop.SHAPES` and `TOP_SHAPE` (serving 16 x
    300, training 16 x 256 at C = 1024 and 512, the mask crops 16 x 2,
    the attribute crops 16 x 1, 'top' 16 x 5000 compared in chunks), with
    the edge ROIs: the forward the bits of its algorithm in torch ops and
    within `FWD_ULPS` of the einsum pair, the backward the bits of its
    fixed-order plain version on two runs and within `BWD_ULPS` of
    autograd of the einsum pair; each timed beside its bound, the plain
    versions and `F.grid_sample` (`library_ms`); then `top_request_16`.
    Returns the checked shapes' numbers by launch key."""
    regs = crop_registers()
    log(f"[roi-crop] registers, stack, spill stores, spill loads: "
        f"{ {f'{a}/{b}': v for (a, b), v in regs.items()} }")
    record["roi_crop_registers"] = {f"{a}/{b}": v
                                    for (a, b), v in regs.items()}
    checked = {}
    for shape in profile_crop.SHAPES + (profile_crop.TOP_SHAPE,):
        name, e, r, h, w, c, maps, train = shape
        res = check_crop_shape_logged(*shape, dev, reps=10)
        checked[roi_crop_cuda.shape_key(e, r, 7, h, w, c,
                                        torch.bfloat16)] = res
        torch.cuda.empty_cache()
    record["top_request_16"] = top_request_16()
    return checked, regs


def crop_entries(res, key, regs, launched):
    """The `kernels` entries of one checked crop shape: the forward's, and
    the backward's when the main path launched it, with the launches at
    exactly that shape."""
    e, r, s, h, w, c, dtype = key
    tag = f"{e}x{r}_{h}x{w}x{c}_{dtype}" + ("" if s == 7 else f"_s{s}")
    fwd = {"name": f"roi_crop_{tag}", "route": "cuda",
           "source": "lang2seg_tpu_torch/csrc/roi_crop.cu",
           "replaces": CROP_REPLACES, "launches": launched["fwd"][key],
           "max_abs_err": res["forward_max_abs_err"], "ms": res["ms"],
           "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
           "bound_by": res["bound_by"], "library_ms": res["library_ms"],
           "kernel": "roi_crop_fwd_kernel", "registers": regs["fwd", dtype]}
    if not launched["bwd"][key]:
        return [fwd]
    return [fwd, {
        "name": f"roi_crop_bwd_{tag}", "route": "cuda",
        "source": "lang2seg_tpu_torch/csrc/roi_crop.cu",
        "replaces": CROP_REPLACES, "launches": launched["bwd"][key],
        "max_abs_err": res["bwd_max_abs_err"], "ms": res["bwd_ms"],
        "plain_ms": res["bwd_plain_ms"], "bound_ms": res["bwd_bound_ms"],
        "bound_by": res["bwd_bound_by"],
        "library_ms": res["bwd_library_ms"],
        "kernel": "roi_crop_bwd_kernel", "registers": regs["bwd", dtype]}]


def crop_launches(checked, regs, dev, main_path):
    """Phase 31, last: the main path's crop launches by shape, from phase 5
    to the 'top' request (`main_path`, the `Launches` since phase 5, with
    the gloo ranks'), one entry each forward and backward; a shape phase 31
    did not check is checked and timed here on maps of its layout
    (gathered where the backward ran, else distinct). Serving (16, 300),
    training (16, 256), the mask crops and 'top' (16, 5000) must have been
    launched. Returns the entries."""
    launched = {"fwd": main_path.by_shape("roi_crop"),
                "bwd": main_path.by_shape("roi_crop_bwd")}
    log(f"[roi-crop] main-path launches by (E, R, S, H, W, C, dtype): "
        f"forward {dict(launched['fwd'])}, backward "
        f"{dict(launched['bwd'])}")
    check(set(launched["bwd"]) <= set(launched["fwd"]),
          "a crop backward launch with no forward at its shape")
    must = {"serving": (16, 300), "training": (16, 256), "top": (16, 5000),
            "mask crops": None}
    for what, er in must.items():
        hit = [k for k in launched["fwd"] if k[3:6] == (40, 64, 1024) and
               (k[:2] == er if er else k[1] in (1, 2))]
        check(hit, f"the main path launched no crop for {what}")
    check(any(k[:2] == (16, 256) for k in launched["bwd"]),
          "the main path launched no crop backward for training")
    entries = []
    for key in sorted(launched["fwd"]):
        e, r, s, h, w, c, dtype = key
        res = checked.get(key)
        if res is None or (launched["bwd"][key] and "bwd_ms" not in res):
            train = bool(launched["bwd"][key])
            res = check_crop_shape_logged(
                f"{e}x{r}_{h}x{w}x{c}_{dtype}", e, r, h, w, c,
                "gathered" if train else "distinct", train, dev, reps=10,
                dtype=getattr(torch, dtype), s=s)
            torch.cuda.empty_cache()
        entries += crop_entries(res, key, regs, launched)
    return entries


# --------------------------------------------------------------- phase 32

BN_ACT_REPLACES = ("none: the JAX package leaves BatchNorm, residual and "
                   "ReLU to XLA's fusion")


def same_outputs(a, b) -> bool:
    """Two results (tensors, or dicts / lists of them) with the same
    bits."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_outputs(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_outputs, a, b))
    if not torch.is_tensor(a):
        return a == b
    if a.is_floating_point():
        return profile_bn_act.same_bits(a, b)
    return torch.equal(a, b)


def bn_act_request_and_step():
    """Phase 32's end to end checks: one full-width serving request of 16
    expressions through Inference.predict, and one full-width `response`
    forward and backward (2 images x 16 expressions, the generators from
    one seed), each with the kernels and with the ResNet's BatchNorms as
    the plain composition: outputs, losses and every parameter's gradient
    bit for bit. Returns the kernels' launches in each."""
    cfg = flagship_config()
    model = build_model(cfg, device="cuda", seed=0)
    inf = Inference(model, cfg)
    b = synthetic_eval_request(cfg, 16, 7, 1.6)

    def predict():
        return inf.predict(b["images"], b["im_hw"], b["labels"])

    def launched(fn):
        since = Launches()
        out = fn()
        torch.cuda.synchronize()
        return out, since.of("bn_act", "bn_act_bwd")
    fused, (served, _) = launched(predict)
    with profile_bn_act.unfused():
        plain, unfused_launched = launched(predict)
    check(served > 0 and unfused_launched == (0, 0),
          "the fused request launched no kernel, or the unfused one did")
    check(same_outputs(fused, plain),
          "a serving request's outputs differ from the composition's")
    del model, inf, fused, plain
    batch = to_device(to_wire(cfg, synthetic_batch(cfg, 2, 16, seed=0)),
                      "cuda")
    states = [create_train_state(cfg, "cuda", seed=0)]
    states.append(create_train_state(
        cfg, "cuda", state_dict=states[0].model.state_dict()))

    def forward_backward(state):
        gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
        losses = _forward_backward(state, batch, gen)
        return losses, [p.grad for p in state.model.parameters()]
    fused, step = launched(lambda: forward_backward(states[0]))
    with profile_bn_act.unfused():
        plain, unfused_launched = launched(
            lambda: forward_backward(states[1]))
    check(min(step) > 0 and unfused_launched == (0, 0),
          "the fused step launched no kernel, or the unfused one did")
    check(same_outputs(fused[0], plain[0]),
          "a train step's losses differ from the composition's")
    check(same_outputs(fused[1], plain[1]),
          "a train step's gradients differ from the composition's")
    log(f"[bn-act] a serving request (16 expressions) and a `response` "
        f"forward and backward equal the composition bit for bit; "
        f"launches: request {served}, step {step[0]} forward, {step[1]} "
        f"backward")
    return {"request_launches": served, "step_launches": list(step)}


def bn_act_launches(main_path):
    """After phase 31, before phase 32: the main path's frozen-BatchNorm
    launches by `bn_act_cuda.shape_key` from phase 5 on (`main_path`, the
    `Launches` since phase 5, with the gloo ranks'), forward and
    backward."""
    launched = {"fwd": main_path.by_shape("bn_act"),
                "bwd": main_path.by_shape("bn_act_bwd")}
    for side in launched:
        log(f"[bn-act] main-path {side} launches by (N, C, H, W, mode, "
            f"dtype): {dict(launched[side])}")
    check(set(launched["bwd"]) <= set(launched["fwd"]),
          "a bn_act backward launch with no forward at its shape")
    record["bn_act_launched"] = {side: {"x".join(map(str, k)): n
                                        for k, n in c.items()}
                                 for side, c in launched.items()}
    return launched


def check_bn_act(dev, launched):
    """Phase 32: the frozen-BatchNorm kernels against the plain
    composition at `profile_bn_act.SHAPES`, timed; then
    `bn_act_request_and_step`. Returns the `kernels` entries, with the
    launches at each shape in `launched` (`bn_act_launches`): every shape
    checked here must have been launched there, the training shapes'
    backward too."""
    regs = kernel_registers(_build.library_path("bn_act").with_name(
        "build.log"))
    log(f"[bn-act] registers, stack, spill stores, spill loads: {regs}")
    entries, shapes = [], []
    for shape in profile_bn_act.SHAPES:
        res = profile_bn_act.check_shape(*shape, dev)
        check(res["forward_equal"] and res["backward_equal"],
              f"bn_act at {res['name']} differs from the composition")
        key = (*res["shape"], profile_bn_act.MODES[res["variant"]],
               res["dtype"])
        passes = [("", "ms", "plain_ms", "bound_ms", "share", "fwd")]
        if "bwd_ms" in res:
            passes.append(("bwd_", "bwd_ms", "bwd_plain_ms", "bwd_bound_ms",
                           "bwd_share", "bwd"))
        for tag, ms, plain, bound, share, side in passes:
            check(launched[side][key] > 0, f"the main path launched no "
                  f"bn_act {side} at {res['name']} {key}")
            log(f"[bn-act] {res['name']} {res['variant']} {tag or 'fwd_'}"
                f"{res['shape']}: {res[ms]:.4f} ms, bound {res[bound]:.4f} "
                f"ms ({100 * res[share]:.1f}%), plain {res[plain]:.4f} ms")
            entries.append({
                "name": f"bn_act_{tag}{res['name']}", "route": "cuda",
                "source": "lang2seg_tpu_torch/csrc/bn_act.cu",
                "replaces": BN_ACT_REPLACES,
                "launches": launched[side][key], "max_abs_err": 0.0,
                "ms": res[ms], "plain_ms": res[plain],
                "bound_ms": res[bound], "bound_by": "bytes",
                "library_ms": None,
                "kernel": f"bn_act_{tag or 'fwd_'}kernel"})
        shapes.append(res)
    host = profile_bn_act.host_us(dev)
    log(f"[bn-act] host us a call (bottleneck's last BN, small map): "
        f"kernel {host['bn_act']:.1f}, composition {host['plain']:.1f}")
    record["bn_act"] = {"shapes": shapes, "registers": regs,
                        "host_us": host, **bn_act_request_and_step()}
    return entries


# ---------------------------------------------------------------- phase 33

def graphed_head(dev):
    """Phase 33: the flagship model's ResNet head as a CUDA graph against
    its eager pass at the serving and eval shapes
    (`profile_head.compare`): the same bits, at most 6 runtime calls a
    graphed call."""
    model = build_model(flagship_config(), device="cuda", seed=0)
    rows = []
    for name, n in profile_head.SHAPES:
        res = profile_head.compare(model.backbone, n, dev)
        log(f"[graphed-head] {name} ({n} x 640 x 1024): bits equal="
            f"{res['bits_equal']}; host ms a call eager "
            f"{res['eager_host_ms']:.3f} / graphed "
            f"{res['graphed_host_ms']:.3f}, device ms "
            f"{res['eager_device_ms']:.3f} / {res['graphed_device_ms']:.3f}"
            f", runtime calls {res['eager_runtime_calls']} / "
            f"{res['graphed_runtime_calls']}; first call "
            f"{res['first_call_s']:.3f} s, pool {res['pool_bytes']} bytes")
        check(res["bits_equal"], f"the graphed head at {name} differs from "
              f"the eager pass")
        check(res["graphed_runtime_calls"] <= 6, f"a graphed head call at "
              f"{name} made {res['graphed_runtime_calls']} runtime calls")
        rows.append({"shape": name, **res})
    record["graphed_head"] = rows
    del model


# ---------------------------------------------------------------- phase 34

def graphed_condition(dev):
    """Phase 34: the flagship model's conditioning, its language half as a
    CUDA graph, against the eager pass at the serving shape and every eval
    mix dispatch shape (`profile_condition.compare`): the same bits, at
    most 12 runtime calls a graphed call, one capture a label shape and
    no eager fallback, the head graph's counters untouched."""
    model = build_model(flagship_config(), device="cuda", seed=0)
    names = [f"{part}.graph_{what}" for part in ("backbone", "condition")
             for what in ("captures", "replays", "eager")]
    before = trace.counters()
    rows = []
    for name, maps, per_map in profile_condition.SHAPES:
        res = profile_condition.compare(model, maps, per_map, dev)
        log(f"[graphed-condition] {name} ({maps} maps x {per_map}): bits "
            f"equal={res['bits_equal']}; host ms a call eager "
            f"{res['eager_host_ms']:.3f} / graphed "
            f"{res['graphed_host_ms']:.3f}, device ms "
            f"{res['eager_device_ms']:.3f} / {res['graphed_device_ms']:.3f}"
            f", runtime calls {res['eager_runtime_calls']} / "
            f"{res['graphed_runtime_calls']}; first call "
            f"{res['first_call_s']:.3f} s, pool {res['pool_bytes']} bytes")
        check(res["bits_equal"], f"the graphed conditioning at {name} "
              f"differs from the eager pass")
        check(res["graphed_runtime_calls"] <= 12, f"a graphed conditioning "
              f"call at {name} made {res['graphed_runtime_calls']} runtime "
              f"calls")
        rows.append({"shape": name, **res})
    after = trace.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in names}
    log(f"[graphed-condition] counters: {delta}")
    check(delta["backbone.graph_captures"] == delta[
        "backbone.graph_replays"] == delta["backbone.graph_eager"] == 0,
        "phase 34 moved the head graph's counters")
    label_shapes = {maps * per_map
                    for _, maps, per_map in profile_condition.SHAPES}
    check(delta["condition.graph_captures"] == len(label_shapes)
          and delta["condition.graph_eager"] == 0,
          "phase 34: not one capture a label shape, or an eager fallback")
    record["graphed_condition"] = {"shapes": rows, "counters": delta}
    del model


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--dp-rank":
        dp_rank_worker(int(sys.argv[2]), sys.argv[3])
        return 0
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
    # the crop and frozen-BatchNorm kernels' launches from here to phase 31
    # (`crop_launches`, `bn_act_launches`)
    main_path = Launches()
    runs = {"serve": serve_full_width()}
    small_reference()
    # the phase-7 trainer is dropped here, so that phase 9's peak memory
    # counts its own step alone
    runs["train"] = train_full_width("train", flagship_config())[0]
    small_train_reference("train_reference", "response")
    cfg = flagship_config("cycle_response")
    runs["train_cycle"], trainer = train_full_width("train_cycle", cfg)
    small_train_reference("train_cycle_reference", "cycle")
    feats = pretrain_captioner(cfg, trainer.state.model)
    del trainer
    kernels += check_eval_kernels(dev, regs)
    phase7_ms = float(np.mean(record["train"]["step_ms"]))
    runs.update(file_backed_path(phase7_ms))
    learning_proof()
    kernels += check_gate_vgg(dev)
    runs["serve_vgg"] = serve_vgg()
    runs["train_vgg"] = train_vgg()
    small_train_reference("train_vgg_reference", "vgg")
    runs.update(host_modes())
    kernels += check_nms_pretrain(dev)
    runs.update(pretrain_stage(dev))
    small_train_reference("pretrain_reference", "pretrain",
                          launches=(0, 0, 0, 0, 0),
                          min_tensors=20)
    runs["train_att"] = attribute_head()
    runs.update(comprehension())
    runs["train_topdown"] = caption_side(cfg, feats)
    del feats
    small_train_reference("att_reference", "response_att")
    small_train_reference("topdown_reference", "topdown")
    pool_kernels, pool_regs = check_roi_pool(dev)
    runs.update(mobilenet_pool())
    small_train_reference("mobilenet_pool_reference", "mobilenet_pool",
                          launches=(0, 1, 1, 1, 1))
    runs.update(demo_and_dumps(dev))
    mode_kernels, runs["eval_modes"] = eval_modes(
        dev, regs, {pc for kr in kernels for pc in kr["launched_by"]})
    kernels += mode_kernels
    runs.update(graphed_steps())
    runs["dp_world1"] = data_parallel_world1()
    runs["dp_gloo"] = data_parallel_two_ranks()
    pool_kernels += pool_launches(runs, pool_kernels, dev, pool_regs)
    crop_checked, crop_regs = check_crop(dev)
    crop_kernels = crop_launches(crop_checked, crop_regs, dev, main_path)
    bn_act_kernels = check_bn_act(dev, bn_act_launches(main_path))
    graphed_head(dev)
    graphed_condition(dev)
    for kr in kernels:
        kr["launches"] = sum(runs[path].get(counter, 0)
                             for path, counter in kr["launched_by"])
    check(all(kr["launches"] > 0 for kr in mode_kernels),
          "a phase-27 shape was not launched on its main path")
    reported = {pc for kr in kernels for pc in kr["launched_by"]}
    check(all(("eval_modes", key) in reported for key in runs["eval_modes"]),
          "a phase-27 launch shape has no kernels entry")
    kernels += pool_kernels + crop_kernels + bn_act_kernels
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "tile_plan", "cluster_size", "kernel", "registers")
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
