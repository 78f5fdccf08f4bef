"""Configuration tree for the PyTorch port (its own copy of the JAX
package's `config.py`, so the port imports nothing of that package).

Mirrors the reference's three-tier config (global EasyDict `cfg` + YAML
overlay + ``--set KEY VALUE`` dotted overrides, see reference
`mask-faster-rcnn/lib/model/config.py:358-387`) as a typed dataclass tree
with the same override semantics. The field set is the JAX package's, so
one YAML overlay drives both; fields that only select a TPU lowering of
the same math are kept for that reason and ignored by the port.

Defaults track the reference's `model/config.py` (res101 experiment):
LR 1e-4, STEPSIZE [360000], ROI batch 256 @ 25% fg, RPN batch 256 @ 50% fg,
RPN pre/post-NMS 12000/2000 train and 6000/300 test, anchors
scales [4,8,16,32] x ratios [0.5,1,2] stride 16, pooling 7, mask 14.

`apply_variant` is the preset table of the JAX package's
`cli/variants.py`; `flagship_config` is the flagship model of its
benchmark (ResNet-101-C4, 7 filters, sigmoid gate, normalized response,
bf16 compute).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    gamma: float = 0.1                      # LR decay factor at each stepsize
    stepsize: Tuple[int, ...] = (360000,)   # iters at which LR *= gamma
    max_iters: int = 600000
    double_bias: bool = False               # biases get lr*(1+double_bias)
    bias_decay: bool = False                # apply weight decay to biases
    truncated: bool = False                 # truncated-normal init
    fused_optimizer: bool = False           # TPU lowering; ignored here
    grad_clip_norm: float = 0.0             # 0 = off (reference ships
                                            # clip_gradient in misc/utils)
    # 10x LR for language/dynamic-filter/response params
    # (reference train_val.py:193-198; disabled in cycle variants)
    lang_lr_mult: float = 10.0

    # ROI sampling (proposal targets)
    roi_batch_size: int = 256
    fg_fraction: float = 0.25
    fg_thresh: float = 0.5
    bg_thresh_hi: float = 0.5
    bg_thresh_lo: float = 0.0
    use_gt: bool = False                    # include GT boxes as candidate rois

    # bbox target normalization
    bbox_normalize_targets: bool = True
    bbox_normalize_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    bbox_normalize_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)

    # RPN targets
    rpn_positive_overlap: float = 0.7
    rpn_negative_overlap: float = 0.3
    rpn_clobber_positives: bool = False
    rpn_fg_fraction: float = 0.5
    rpn_batchsize: int = 256
    rpn_positive_weight: float = -1.0

    # RPN proposal filtering
    rpn_pre_nms_top_n: int = 12000
    rpn_post_nms_top_n: int = 2000
    rpn_nms_thresh: float = 0.7

    # snapshots
    snapshot_iters: int = 5000
    snapshot_kept: int = 120
    snapshot_prefix: str = "res101_mask_rcnn"
    display: int = 20
    summary_interval: int = 500
    debug_save_dir: str = ""

    # image preprocessing
    scales: Tuple[int, ...] = (600,)
    max_size: int = 1000

    # batching (ours; reference is 1 sentence / step)
    expressions_per_batch: int = 8
    images_per_batch: int = 2
    steps_per_dispatch: int = 1             # K > 1: K steps a dispatch, a
                                            # CUDA graph of the step replayed
                                            # K times (engine/train_state.py)


@dataclass
class TestConfig:
    mode: str = "nms"                       # 'nms' | 'top'
    rpn_pre_nms_top_n: int = 6000
    rpn_post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    rpn_top_n: int = 5000                   # for mode='top'
    scales: Tuple[int, ...] = (600,)
    max_size: int = 1000
    mask_threshold: float = 122.0 / 255.0   # paste-back binarization (test.py:334)


@dataclass
class ModelConfig:
    # 'resnet101' | 'resnet50' | 'vgg16' | 'mobilenet_v1'
    backbone: str = "resnet101"
    num_classes: int = 81
    anchor_scales: Tuple[int, ...] = (4, 8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    feat_stride: int = 16
    pooling_size: int = 7
    mask_size: int = 14
    pooling_mode: str = "crop"              # 'crop' | 'pool' (POOLING_MODE, config.py:273)
    # NMS tile sizes and kernel choice of the JAX package (TPU lowerings of
    # the same greedy NMS); the port always runs ops/nms_cuda.py on a card
    nms_block: int = 256
    nms_pallas_block: int = 512
    nms_pallas_chunk: int = 512
    nms_impl: str = "auto"
    max_pool: bool = False                  # crop 2x then maxpool (RESNET.MAX_POOL)
    fixed_blocks: int = 1                   # frozen resnet stages (conv1 always frozen)
    c4_feat_dim: int = 1024                 # 512 for vgg16

    # language encoder (reference tools/opt.py defaults)
    vocab_size: int = 2000                  # overwritten from dataset vocab
    word_embedding_size: int = 512
    word_vec_size: int = 512
    rnn_hidden_size: int = 512
    rnn_num_layers: int = 1
    bidirectional: bool = True
    word_drop_out: float = 0.5
    rnn_drop_out: float = 0.2
    rnn_type: str = "lstm"
    variable_lengths: bool = True

    # language conditioning on/off (off = plain Mask R-CNN, the
    # coco_minus_refer pretraining capability, SURVEY §3.5)
    use_language: bool = True

    # dynamic-filter conditioning
    num_filters: int = 1                    # 1 (baseline) | 7 (spatial)
    response_gate: str = "multiply"         # 'multiply' | 'sigmoid' (response variants)
    normalize_response: bool = False        # 1/sqrt(C) response scaling (scratch-training aid)
    use_pallas: bool = False                # TPU kernel switch; the port
                                            # always gates through
                                            # ops/fused_filter.py

    # loss set (the reference's per-variant network files collapse to this)
    use_mask_head: bool = True              # False for vgg detection-only variant
    use_response_loss: bool = False
    use_caption_loss: bool = False
    cap_loss_weight: float = 1.0

    # attribute prediction (MAttNet-lineage capability)
    use_attribute_head: bool = False
    num_attributes: int = 50
    att_loss_weight: float = 1.0

    # captioner (reference tools/opt_cycle.py:81-117): att2in2, or another
    # decoder of models/caption_zoo.py (teacher-forced only)
    caption_model: str = "att2in2"
    cap_vocab_size: int = 2000
    cap_seq_length: int = 10
    cap_rnn_size: int = 512
    cap_input_encoding_size: int = 512
    cap_att_hid_size: int = 512
    cap_fc_feat_size: int = 4096
    cap_att_feat_size: int = 4096
    cap_drop_prob_lm: float = 0.5
    cap_scheduled_sampling_prob: float = 0.0
    # annealing schedule (opt_cycle.py:106-109), epoch-indexed
    cap_ss_start: int = -1                  # -1 = disabled
    cap_ss_increase_every: int = 5
    cap_ss_increase_prob: float = 0.05
    cap_ss_max_prob: float = 0.25

    # numerics
    compute_dtype: str = "bfloat16"         # backbone conv compute dtype
    param_dtype: str = "float32"
    # TPU lowerings of the same math in the JAX package (explicit-matmul
    # tail, fused bi-LSTM scan, matmul deconv, space-to-depth stem, mosaic
    # tail); the port runs the plain form of each
    tail_matmul: bool = False
    fused_bidir_encoder: bool = True
    mask_up_matmul: bool = True
    head_s2d: bool = False
    tail_mosaic: bool = False


@dataclass
class DataConfig:
    dataset: str = "refcoco"
    split_by: str = "unc"
    data_root: str = "data"
    image_dir: str = "data/images/train2014"
    # fixed canvas. Images are resized per the reference rule (min side ->
    # 600 capped so max side <= 1000), additionally capped to fit the
    # canvas, then zero-padded bottom-right.
    canvas_h: int = 640
    canvas_w: int = 1024
    max_len: int = 10                       # 20 for refcocog
    pixel_means_bgr: Tuple[float, float, float] = (102.9801, 115.9465, 122.7717)
    max_gt_per_image: int = 8               # padded GT slots per image
    # fixed original-resolution buffers for the device-paste eval path
    # (engine/evaluator.py): COCO images are <= 640 per side
    max_orig_h: int = 640
    max_orig_w: int = 640
    # wire formats: raw uint8 BGR canvases (mean subtraction on device)
    # and bit-packed GT masks
    wire_uint8_images: bool = True
    wire_packed_masks: bool = True
    # eval wire formats: the ref-deduped mask bank (the loader and the
    # Evaluator) and the extent crop (the Evaluator ships a uint8 canvas
    # and its masks cut to the scaled extent rounded up to
    # wire_extent_granularity, a multiple of 8 since bit-packed masks crop
    # at byte boundaries, and re-creates the full canvas on the device).
    # The reference-exact masks resize GT masks as the reference's scipy
    # imresize does (Pillow NEAREST)
    wire_mask_bank: bool = True
    wire_extent_crop: bool = True
    wire_extent_granularity: int = 128
    reference_exact_masks: bool = False


@dataclass
class ParallelConfig:
    data_axis: str = "data"
    num_data: int = 1                       # data-parallel degree: ranks of
                                            # the process group, one block of
                                            # each batch a rank (parallel/)


@dataclass
class Config:
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    seed: int = 3                           # cfg.RNG_SEED
    exp_dir: str = "output"
    tag: str = "default"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _set_dotted(obj: Any, key: str, value: Any) -> None:
    parts = key.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"unknown config key: {key}")
    old = getattr(obj, leaf)
    # type-checked coercion (parity with reference cfg_from_list type checks)
    if old is not None and not isinstance(value, type(old)):
        if isinstance(old, bool):
            value = str(value).lower() in ("1", "true", "yes")
        elif isinstance(old, int) and not isinstance(old, bool):
            value = int(value)
        elif isinstance(old, float):
            value = float(value)
        elif isinstance(old, tuple):
            value = tuple(value) if isinstance(value, (list, tuple)) else tuple(
                type(old[0])(v) for v in str(value).strip("[]()").split(","))
        elif isinstance(old, str):
            value = str(value)
        else:
            raise TypeError(f"cannot coerce {value!r} to {type(old)} for {key}")
    object.__setattr__(obj, leaf, value)


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply ``["train.learning_rate", "1e-3", ...]`` pair-list overrides
    (semantics of the reference's ``--set`` / cfg_from_list)."""
    assert len(overrides) % 2 == 0, "overrides must be KEY VALUE pairs"
    for k, v in zip(overrides[0::2], overrides[1::2]):
        _set_dotted(cfg, k, v)
    return cfg


def _update_from_dict(obj: Any, d: dict, prefix: str = "") -> None:
    for k, v in d.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key: {prefix}{k}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _update_from_dict(cur, v, prefix=f"{prefix}{k}.")
        else:
            _set_dotted(obj, k, v)


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[List[str]] = None) -> Config:
    """Build a Config: defaults <- YAML overlay <- dotted overrides."""
    cfg = Config()
    if yaml_path is not None:
        import yaml
        with open(yaml_path) as f:
            d = yaml.safe_load(f) or {}
        _update_from_dict(cfg, d)
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


VARIANTS = ("baseline", "spatial", "response", "vgg", "cycle",
            "cycle_response", "pretrain")


def apply_variant(cfg: Config, variant: str) -> Config:
    """Named presets of the reference's per-variant entry points
    (tools/train_*.py). The port trains and serves `baseline`, `spatial`,
    `response`, `vgg` (VGG16, detection-only), `cycle` and
    `cycle_response`, and trains `pretrain` (the plain Mask R-CNN, no
    language), which it cannot serve, as the JAX package cannot."""
    m, t = cfg.model, cfg.train
    if variant == "baseline":
        m.num_filters = 1
        m.response_gate = "multiply"
    elif variant == "spatial":
        m.num_filters = 7
        m.response_gate = "multiply"
    elif variant == "response":
        m.num_filters = 7
        m.response_gate = "sigmoid"
        m.use_response_loss = True
    elif variant == "vgg":
        m.backbone = "vgg16"
        m.c4_feat_dim = 512
        m.num_filters = 7
        m.response_gate = "sigmoid"
        m.use_response_loss = True
        m.use_mask_head = False
        t.weight_decay = 5e-4
        t.double_bias = True
        t.snapshot_prefix = "vgg16_faster_rcnn"
    elif variant == "cycle":
        m.num_filters = 7
        m.response_gate = "multiply"
        m.use_caption_loss = True
        t.lang_lr_mult = 1.0
        t.max_iters = 800000
    elif variant == "pretrain":
        m.use_language = False
        t.max_iters = 1250000
    elif variant == "cycle_response":
        m.num_filters = 7
        m.response_gate = "sigmoid"
        m.use_response_loss = True
        m.use_caption_loss = True
        t.lang_lr_mult = 1.0
        t.max_iters = 800000
    else:
        raise ValueError(f"unknown variant {variant}; one of {VARIANTS}")
    return cfg


def flagship_config(variant: str = "response") -> Config:
    """The `response` variant at full width: ResNet-101-C4 in bf16, bi-LSTM
    512 per direction, 7 spatial filters with a sigmoid gate and the
    1/sqrt(C) response normalization, on the 640x1024 canvas. Another
    `variant` gives that preset at the same width with the normalization,
    as the JAX package's experiments/bench_variants.py builds it (e.g.
    `cycle_response`, the paper's full model). The `vgg` preset keeps its
    VGG16 (C4 512, detection-only); `pretrain` is ResNet-101-C4 in bf16
    without language, with up to cfg.data.max_gt_per_image (8) GT boxes
    and masks an image."""
    cfg = apply_variant(Config(), variant)
    if cfg.model.backbone != "vgg16":
        cfg.model.backbone = "resnet101"
    cfg.model.normalize_response = True
    return cfg
