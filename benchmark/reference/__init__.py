"""Plain references of the benchmarked networks, one module a network.

A configuration file (`benchmark/configs/<name>.json`) names its module
under the top-level key `"reference"` (a file of this directory, without
`.py`); where the key is absent the module is `model`, the ResNet-C4
network. `benchmark.harness.reference_of` is the one place that finds it;
the weights, the checks (`benchmark/check.py`) and the FLOP count
(`benchmark/flops/`) all go through what it returns.

What a module exports:

* `Reference(cfg, precision="float32")`, an `nn.Module` built from the
  configuration's `config` tree, with `precision` "float32" (the
  reference) or "fp8" (the control). It has:
  - `reference_state_keys()`: its parameters and buffers under the
    program's state-dict keys (the weights' shapes come from it, on the
    meta device); `load_reference_state(sd)` copies such a dict in;
  - `set_frozen()`: requires_grad off where the configuration freezes;
  - `condition(images, labels)` -> (net_conv, gated, response);
    `rpn_outputs(gated)` -> (score_pos, deltas, (h, w));
    `box_outputs(gated, rois)` -> (cls_score, de-normalized bbox_pred);
    `mask_probs(gated, boxes, labels)`; `test_forward(images, im_hw,
    labels)` -> a dict with rois, roi_valid, cls_score, bbox_pred,
    response, gated, score_pos, deltas;
  - `train_forward(batch, generator, proposals=None)` -> the dict of
    losses with `total_loss` and `rpn_cross_entropy`, drawing its random
    numbers from `generator` in the program's order; while `_capture` is
    a dict, the RPN outputs and proposals of its own NMS go into it;
  - `crop`, the ROI crop it calls, which the FLOP count replaces by
    `crop_gather`.
* Functions: `frozen_statistics(sd, cfg, seed, device)`, which sets in
  the drawn weights `sd` what the network freezes (a module whose network
  has none sets nothing); `proposal_layer`, `shifted_anchors`,
  `select_boxes`, `paste_iou`, `crop_gather`; `namespace`,
  `param_groups` and `PlainSGD` for the reference's training steps.

A module computes in plain PyTorch with TF32 off (the harness turns it
off before any check), may import the plain parts of `model.py` that it
shares, and imports nothing of the program, of its JAX original or of
JAX.
"""
