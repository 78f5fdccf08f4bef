"""PyTorch/CUDA port of lang2seg_tpu for NVIDIA Hopper.

The serving path and the training step of the `response` variant
(ResNet-101-C4, bi-LSTM, 7 spatial dynamic filters with a sigmoid gate,
RPN with NMS, ROI crop, layer4 tail, box and selected-class mask heads;
in training also the anchor and ROI samplers, the five losses and the
per-group SGD) run in PyTorch, with three hand-written CUDA kernels:
greedy NMS (`ops/nms_cuda.py`), and the fused conditioning gate and its
gradient (`ops/fused_filter.py`). The module layout
mirrors `lang2seg_tpu/` so each counterpart is found under the same
name; public functions keep its NHWC layouts.
"""
