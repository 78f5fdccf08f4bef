"""The plain reference of the benchmarked model, in float32.

A frozen copy of the plain code paths of the measured program (ResNet-C4
with frozen BatchNorm, the bi-LSTM encoder, the seven dynamic filters with
the sigmoid gate, the RPN, greedy NMS, the bilinear ROI crop as two
contractions, the layer4 tail, the box and selected-class mask heads, the
anchor and ROI samplers, the losses, the att2in2 caption loss and
per-group momentum SGD), written with plain torch operations and no
kernel. It imports nothing of the program: the benchmark hands it the
configuration (the nested dict of a `benchmark/configs/*.json` file), the
weights (a state dict under the reference network's keys) and the inputs.

`precision` selects the arithmetic of every convolution, linear layer and
matrix product: "float32" (the reference; the caller turns TF32 off) or
"fp8" (the control: inputs and weights rounded to float8 e4m3 with a
per-tensor scale before an f32 product). Random draws (word dropout, the
anchor and ROI sampling priorities, the captioner's dropout) come from the
caller's `torch.Generator` in the program's order and shapes, so a
generator seeded as the program's draws the same numbers on the same
device.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

STAGE_BLOCKS = {"resnet26": (1, 1, 1, 1), "resnet50": (3, 4, 6, 3),
                "resnet101": (3, 4, 23, 3), "resnet152": (3, 8, 36, 3)}
LANG_PREFIXES = ("rnn_encoder.", "dynamic_fc", "response_fc.")
CAPTIONER_RAW_BIASES = tuple(
    f"caption_model.{layer}.bias" for layer in (
        "logit", "core.i2h", "core.h2h", "core.a2c", "core.attention.h2att",
        "core.attention.alpha_net"))
_BIG = 1e9


def namespace(tree: Dict) -> SimpleNamespace:
    """A nested dict as attribute access (cfg.model.num_filters)."""
    return SimpleNamespace(**{k: namespace(v) if isinstance(v, dict) else v
                              for k, v in tree.items()})


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to an fp8 type with a per-tensor scale that maps its
    largest magnitude to the type's largest value."""
    top = torch.finfo(dtype).max
    amax = x.abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _FakeFp8(torch.autograd.Function):
    """fp8 training's rounding: operands in e4m3 on the way forward,
    gradients in e5m2 on the way back, each with a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad, torch.float8_e5m2)


class Precision:
    """Rounds the operands of a product: nothing in f32; in "fp8", to
    float8 e4m3 forward and their gradients to e5m2 backward (per-tensor
    scales)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        return _FakeFp8.apply(x)


def _rand(shape, generator, device):
    """Uniforms as the program draws them: from `generator` on its own
    device, moved to `device`; shaped empties on the meta device."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


# ---------------------------------------------------------------------------
# boxes, anchors, NMS, proposals
# ---------------------------------------------------------------------------

def encode_boxes(ex, gt):
    ex_w = torch.clamp(ex[..., 2] - ex[..., 0] + 1.0, min=1e-6)
    ex_h = torch.clamp(ex[..., 3] - ex[..., 1] + 1.0, min=1e-6)
    ex_cx = ex[..., 0] + 0.5 * ex_w
    ex_cy = ex[..., 1] + 0.5 * ex_h
    gt_w = torch.clamp(gt[..., 2] - gt[..., 0] + 1.0, min=1e-6)
    gt_h = torch.clamp(gt[..., 3] - gt[..., 1] + 1.0, min=1e-6)
    gt_cx = gt[..., 0] + 0.5 * gt_w
    gt_cy = gt[..., 1] + 0.5 * gt_h
    return torch.stack([(gt_cx - ex_cx) / ex_w, (gt_cy - ex_cy) / ex_h,
                        torch.log(gt_w / ex_w), torch.log(gt_h / ex_h)], -1)


def decode_boxes(boxes, deltas):
    out_shape = deltas.shape
    d = deltas.reshape(*deltas.shape[:-1], -1, 4)
    w = (boxes[..., 2] - boxes[..., 0] + 1.0)[..., None]
    h = (boxes[..., 3] - boxes[..., 1] + 1.0)[..., None]
    cx = boxes[..., 0][..., None] + 0.5 * w
    cy = boxes[..., 1][..., None] + 0.5 * h
    pcx = d[..., 0] * w + cx
    pcy = d[..., 1] * h + cy
    pw = torch.exp(torch.clamp(d[..., 2], max=10.0)) * w
    ph = torch.exp(torch.clamp(d[..., 3], max=10.0)) * h
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                       pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
    return out.reshape(out_shape)


def clip_boxes(boxes, im_h, im_w):
    out_shape = boxes.shape
    b = boxes.reshape(*boxes.shape[:-1], -1, 4)
    hi_x, hi_y = im_w - 1.0, im_h - 1.0
    x1 = torch.clamp(torch.clamp(b[..., 0], min=0.0), max=hi_x)
    y1 = torch.clamp(torch.clamp(b[..., 1], min=0.0), max=hi_y)
    x2 = torch.clamp(torch.clamp(b[..., 2], min=0.0), max=hi_x)
    y2 = torch.clamp(torch.clamp(b[..., 3], min=0.0), max=hi_y)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(out_shape)


def box_iou(a, b):
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = torch.clamp(rb - lt + 1.0, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def base_anchors(ratios, scales, base_size: int = 16) -> np.ndarray:
    ratios = np.asarray(ratios, np.float64)
    scales = np.asarray(scales, np.float64)
    ctr = (base_size - 1) * 0.5
    size = float(base_size * base_size)
    out = []
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            sw, sh = ws * s, hs * s
            out.append([ctr - 0.5 * (sw - 1), ctr - 0.5 * (sh - 1),
                        ctr + 0.5 * (sw - 1), ctr + 0.5 * (sh - 1)])
    return np.asarray(out, np.float32)


def shifted_anchors(h, w, stride, scales, ratios, device) -> torch.Tensor:
    """(H * W * A, 4) anchors in (H, W, A) order."""
    base = base_anchors(ratios, scales)
    sx = np.arange(w, dtype=np.float32) * stride
    sy = np.arange(h, dtype=np.float32) * stride
    shift = np.stack([np.tile(sx[None, :], (h, 1)),
                      np.tile(sy[:, None], (1, w)),
                      np.tile(sx[None, :], (h, 1)),
                      np.tile(sy[:, None], (1, w))], axis=-1)
    anchors = (shift[:, :, None, :] + base[None, None]).reshape(-1, 4)
    return torch.from_numpy(np.ascontiguousarray(anchors)).to(device)


def nms_padded(boxes, valid, iou_thresh: float, max_out: int):
    """Greedy NMS over score-sorted (E, N, 4) boxes, a lane an expression:
    (keep_idx (E, max_out) int32, 0-padded; keep_mask (E, max_out))."""
    e, n, _ = boxes.shape
    dev = boxes.device
    thresh = torch.tensor(iou_thresh, dtype=torch.float32, device=dev)
    sup = torch.empty((e, n, n), dtype=torch.bool, device=dev)
    for r0 in range(0, n, 1024):
        rows = boxes[:, r0:r0 + 1024].float()
        sup[:, r0:r0 + rows.shape[1]] = box_iou(rows, boxes.float()) > thresh
    sup = torch.triu(sup, diagonal=1)
    removed = ~valid.to(torch.bool)
    keep = torch.zeros((e, n), dtype=torch.bool, device=dev)
    for i in range(n):
        k = ~removed[:, i]
        keep[:, i] = k
        removed |= sup[:, i] & k[:, None]
    pos = torch.where(keep, torch.cumsum(keep.to(torch.int64), 1) - 1,
                      max_out).clamp(max=max_out)
    slots = torch.zeros((e, max_out + 1), dtype=torch.int32, device=dev)
    ranks = torch.arange(n, dtype=torch.int32, device=dev).expand(e, n)
    slots.scatter_(1, pos, ranks)
    total = keep.sum(1).clamp(max=max_out)
    keep_mask = torch.arange(max_out, device=dev)[None, :] < total[:, None]
    return torch.where(keep_mask, slots[:, :max_out], 0), keep_mask


class Proposals(NamedTuple):
    rois: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor


def nms_inputs(scores, deltas, anchors, im_h, im_w, pre_nms_n: int):
    """The score-sorted, decoded and clipped top boxes NMS reads, with
    their scores: ((E, K, 4), (E, K))."""
    e, n = scores.shape
    im_h = torch.as_tensor(im_h, dtype=torch.float32, device=scores.device)
    im_w = torch.as_tensor(im_w, dtype=torch.float32, device=scores.device)
    if im_h.dim() == 1:
        im_h, im_w = im_h.reshape(e, 1, 1), im_w.reshape(e, 1, 1)
    boxes = clip_boxes(decode_boxes(anchors, deltas.float()), im_h, im_w)
    k = min(pre_nms_n, n)
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
    return (torch.gather(boxes, 1, order[..., None].expand(e, k, 4)),
            torch.gather(scores, 1, order))


def proposal_layer(scores, deltas, anchors, im_h, im_w, pre_nms_n: int,
                   post_nms_n: int, nms_thresh: float,
                   nms=nms_padded) -> Proposals:
    """decode -> clip -> stable sort to pre_nms_n -> NMS -> post_nms_n."""
    e = scores.shape[0]
    top_boxes, top_scores = nms_inputs(scores, deltas, anchors, im_h, im_w,
                                       pre_nms_n)
    keep_idx, keep_mask = nms(top_boxes.contiguous(), torch.ones(
        top_scores.shape, dtype=torch.bool, device=scores.device),
        nms_thresh, post_nms_n)
    ki = keep_idx.long()
    rois = torch.gather(top_boxes, 1, ki[..., None].expand(e, post_nms_n, 4))
    return Proposals(rois, torch.gather(top_scores, 1, ki), keep_mask)


# ---------------------------------------------------------------------------
# the ROI crop (two contractions with hat weights)
# ---------------------------------------------------------------------------

def sample_coords(rois, s: int, spatial_scale: float):
    x1, y1 = rois[..., 0] * spatial_scale, rois[..., 1] * spatial_scale
    x2, y2 = rois[..., 2] * spatial_scale, rois[..., 3] * spatial_scale
    t = torch.arange(s, dtype=torch.float32, device=rois.device) / (s - 1)
    return (y1[..., None] + (y2 - y1)[..., None] * t,
            x1[..., None] + (x2 - x1)[..., None] * t)


def _hat(coords, n: int):
    idx = torch.arange(n, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(coords[..., None] - idx), min=0.0)


def crop_and_resize(feat, rois, s: int, spatial_scale: float,
                    chunk: int = 64):
    """feat (E, H, W, C) f32, rois (E, R, 4) -> (E, R, S, S, C): bilinear
    samples at linspace(x1, x2, S) x linspace(y1, y2, S) in map cells,
    zero outside the map; `chunk` ROIs at a time to bound memory."""
    ys, xs = sample_coords(rois.float(), s, spatial_scale)
    h, w = feat.shape[1], feat.shape[2]
    outs = []
    for r0 in range(0, rois.shape[1], chunk):
        wy = _hat(ys[:, r0:r0 + chunk], h)
        wx = _hat(xs[:, r0:r0 + chunk], w)
        tmp = torch.einsum("eyxc,erjx->eryjc", feat, wx)
        outs.append(torch.einsum("eriy,eryjc->erijc", wy, tmp))
    return torch.cat(outs, 1)


def crop_gather(feat, rois, s: int, spatial_scale: float):
    """The same samples by gathering each sample's four taps (no matrix
    product): what `benchmark/flops/` counts, which counts products."""
    ys, xs = sample_coords(rois.float(), s, spatial_scale)
    e, h, w, c = feat.shape
    ar = torch.arange(e, device=feat.device)[:, None, None, None]
    out = 0.0
    for yk in (0, 1):
        yi = torch.floor(ys) + yk
        wy = torch.clamp(1.0 - torch.abs(ys - yi), min=0.0) * \
            ((yi >= 0) & (yi < h))
        for xk in (0, 1):
            xi = torch.floor(xs) + xk
            wx = torch.clamp(1.0 - torch.abs(xs - xi), min=0.0) * \
                ((xi >= 0) & (xi < w))
            v = feat[ar, yi.clamp(0, h - 1).long()[:, :, :, None],
                     xi.clamp(0, w - 1).long()[:, :, None, :]]
            out = out + (wy[:, :, :, None] * wx[:, :, None, :])[..., None] * v
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def conv2d_gemm(x, w, b=None, stride: int = 1, padding: int = 0):
    """A 2-d convolution (NCHW, square kernel and stride) as one matrix
    product over the unfolded input, so that it runs on the GEMM library
    and never on a convolution library (on the H100, cuDNN's f32 3 x 3
    convolution at 16 x 1024 x 40 x 64 read 18% off both the CPU and its
    own result on halves of the batch)."""
    n, c, h, wd = x.shape
    o, _, k, _ = w.shape
    ho = (h + 2 * padding - k) // stride + 1
    wo = (wd + 2 * padding - k) // stride + 1
    if k == 1 and padding == 0:
        xs = x[:, :, ::stride, ::stride]
        out = torch.matmul(w.reshape(o, c), xs.reshape(n, c, ho * wo))
    else:
        cols = F.unfold(x, k, padding=padding, stride=stride)
        out = torch.matmul(w.reshape(o, c * k * k), cols)
    out = out.reshape(n, o, ho, wo)
    return out if b is None else out + b[:, None, None]


class Conv2d(nn.Conv2d):
    prec = Precision()          # each instance's is set by `Reference`

    def forward(self, x):
        return conv2d_gemm(self.prec(x), self.prec(self.weight), self.bias,
                           self.stride[0], self.padding[0])


class Linear(nn.Linear):
    prec = Precision()          # each instance's is set by `Reference`

    def forward(self, x):
        return F.linear(self.prec(x), self.prec(self.weight), self.bias)


class FrozenBatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((features,), fill))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        offset = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + offset[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = (nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            FrozenBatchNorm(planes * 4)) if downsample else None)

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + res)


def _stage(inplanes, planes, blocks, stride):
    return nn.Sequential(Bottleneck(inplanes, planes, stride, True),
                         *[Bottleneck(planes * 4, planes)
                           for _ in range(1, blocks)])


class ResNetC4(nn.Module):
    def __init__(self, depth: str):
        super().__init__()
        b = STAGE_BLOCKS[depth]
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = _stage(64, 64, b[0], 1)
        self.layer2 = _stage(256, 128, b[1], 2)
        self.layer3 = _stage(512, 256, b[2], 2)
        self.layer4 = _stage(1024, 512, b[3], 1)

    def head(self, images):                      # (B, H, W, 3) -> NHWC C4
        x = images.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        return self.layer3(self.layer2(self.layer1(x))).permute(0, 2, 3, 1)

    def tail(self, x):                           # (R, S, S, 1024) NHWC
        return self.layer4(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def word_dropout(x, p: float, generator):
    keep_p = 1.0 - p
    keep = _rand(x.shape, generator, x.device) < keep_p
    return torch.where(keep, x / keep_p, torch.zeros_like(x))


class RNNEncoder(nn.Module):
    """Embedding -> word dropout -> Linear + ReLU -> bi-LSTM over each
    row's valid prefix (padding token 0)."""

    def __init__(self, m):
        super().__init__()
        self.hidden_size = m.rnn_hidden_size
        self.p = m.word_drop_out
        self.embedding = nn.Embedding(m.vocab_size, m.word_embedding_size)
        self.mlp = nn.Sequential(Linear(m.word_embedding_size,
                                        m.word_vec_size), nn.ReLU())
        self.rnn = nn.LSTM(m.word_vec_size, m.rnn_hidden_size, 1,
                           batch_first=True, bidirectional=True)

    def forward(self, labels, generator=None):
        b, t = labels.shape
        lengths = (labels != 0).sum(1)
        emb = self.embedding(labels.long())
        if self.training and self.p > 0.0:
            emb = word_dropout(emb, self.p, generator)
        emb = self.mlp(emb)
        d = emb.shape[-1]
        pos = torch.arange(t, device=labels.device)[None, :]
        valid = pos < lengths[:, None]
        rev = torch.clamp(lengths[:, None] - 1 - pos, 0, t - 1)
        x2 = torch.stack([emb, torch.gather(emb, 1,
                                            rev[..., None].expand(b, t, d))])
        r = self.rnn
        q = self.prec
        w_ih = torch.stack([r.weight_ih_l0, r.weight_ih_l0_reverse])
        w_hh = torch.stack([r.weight_hh_l0, r.weight_hh_l0_reverse])
        bias = torch.stack([r.bias_ih_l0 + r.bias_hh_l0,
                            r.bias_ih_l0_reverse + r.bias_hh_l0_reverse])
        gx = torch.einsum("nbtd,ngd->nbtg", q(x2), q(w_ih))
        hsz = self.hidden_size
        h = emb.new_zeros((2, b, hsz))
        c = emb.new_zeros((2, b, hsz))
        for step in range(t):
            gates = gx[:, :, step] + torch.bmm(q(h), q(w_hh).transpose(1, 2)) \
                + bias[:, None, :]
            i, f, g, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            v = valid[None, :, step, None]
            h = torch.where(v, h_new, h)
            c = torch.where(v, c_new, c)
        return torch.cat([h[0], h[1]], dim=-1)


def spatial_masks_7(h, w, device):
    ys = torch.arange(h, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, device=device)[None, :].expand(h, w)
    return torch.stack([torch.ones((h, w), dtype=torch.bool, device=device),
                        ys < h // 2, ys >= h // 2, xs < w // 2, xs >= w // 2,
                        (ys >= h // 4) & (ys < (h * 3) // 4),
                        (xs >= w // 4) & (xs < (w * 3) // 4)]).float()


class DynamicFilterGen(nn.Module):
    """Seven tanh(Linear(hidden)) filters and their response weights; the
    response is each filter's map product times 1/sqrt(C), masked to its
    region and fused, and the map is gated by its sigmoid."""

    def __init__(self, m):
        super().__init__()
        hidden = 2 * m.rnn_hidden_size
        self.k = m.num_filters
        self.gate = m.response_gate
        self.normalize = m.normalize_response
        for k in range(self.k):
            self.add_module(f"dynamic_fc_{k}", Linear(hidden, m.c4_feat_dim))
        self.response_fc = Linear(hidden, self.k)

    def forward(self, net_conv, hidden, exprs_per_map: int = 1):
        filt = torch.stack([torch.tanh(getattr(self, f"dynamic_fc_{k}")(
            hidden)) for k in range(self.k)], dim=-1)          # (E, C, K)
        rfilt = torch.tanh(self.response_fc(hidden))            # (E, K)
        if exprs_per_map > 1:
            n = net_conv.shape[0]
            net_conv = net_conv[:, None].expand(
                n, exprs_per_map, *net_conv.shape[1:]).reshape(
                    n * exprs_per_map, *net_conv.shape[1:])
        e, h, w, c = net_conv.shape
        q = self.prec
        resp = torch.matmul(q(net_conv).reshape(e, h * w, c), q(filt))
        resp = resp.reshape(e, h, w, self.k)
        if self.normalize:
            resp = resp * (1.0 / (c ** 0.5))
        resp = resp * spatial_masks_7(h, w, net_conv.device).permute(
            1, 2, 0)[None]
        fused = torch.sum(resp * rfilt[:, None, None, :], -1, keepdim=True)
        g = torch.sigmoid(fused) if self.gate == "sigmoid" else fused
        return net_conv * g, fused


class RPNHead(nn.Module):
    def __init__(self, c4: int, a: int):
        super().__init__()
        self.a = a
        self.rpn_net = Conv2d(c4, 512, 3, padding=1)
        self.rpn_cls_score_net = Conv2d(512, 2 * a, 1)
        self.rpn_bbox_pred_net = Conv2d(512, 4 * a, 1)

    def forward(self, x):
        rpn = F.relu(self.rpn_net(x.permute(0, 3, 1, 2)))
        cls, box = self.rpn_cls_score_net(rpn), self.rpn_bbox_pred_net(rpn)
        e, _, h, w = cls.shape
        return (cls.reshape(e, 2, self.a, h, w).permute(0, 3, 4, 2, 1),
                box.reshape(e, self.a, 4, h, w).permute(0, 3, 4, 1, 2))


class BoxHead(nn.Module):
    def __init__(self, d: int, k: int):
        super().__init__()
        self.cls_score_net = Linear(d, k)
        self.bbox_pred_net = Linear(d, 4 * k)

    def forward(self, fc7):
        x = fc7.mean(dim=(1, 2))
        return self.cls_score_net(x), self.bbox_pred_net(x)


class MaskHead(nn.Module):
    """ConvTranspose 2x2/2 to 256 + ReLU, then the labelled class's 1x1
    conv column."""

    def __init__(self, d: int, k: int):
        super().__init__()
        self.mask_up_sampling = nn.ConvTranspose2d(d, 256, 2, stride=2)
        self.mask_pred_net = nn.Conv2d(256, k, 1)

    def forward(self, fc7, labels):
        q = self.prec
        up = self.mask_up_sampling
        r, h, w, c = fc7.shape
        f = up.weight.shape[1]
        # the 2 x 2 stride-2 deconvolution has no overlapping taps: one
        # product to 4 f channels, then depth to space
        y = torch.matmul(q(fc7.reshape(-1, c)), q(up.weight.reshape(c, f * 4)))
        y = y.reshape(r, h, w, f, 2, 2).permute(0, 3, 1, 4, 2, 5)
        y = F.relu(y.reshape(r, f, 2 * h, 2 * w) + up.bias[:, None, None])
        wk = self.mask_pred_net.weight[labels.long(), :, 0, 0]   # (R, 256)
        b = self.mask_pred_net.bias[labels.long()]
        return torch.einsum("rfhw,rf->rhw", q(y), q(wk)) + b[:, None, None]


class _Attention(nn.Module):
    def __init__(self, rnn: int, hid: int):
        super().__init__()
        self.h2att = Linear(rnn, hid)
        self.alpha_net = Linear(hid, 1)

    def forward(self, h, att, p_att):
        e = self.alpha_net(torch.tanh(p_att + self.h2att(h)[:, None]))[..., 0]
        w = torch.softmax(e, dim=-1)
        return torch.bmm(w[:, None, :], att)[:, 0]


class _Core(nn.Module):
    def __init__(self, enc: int, rnn: int, hid: int):
        super().__init__()
        self.r = rnn
        self.i2h = Linear(enc, 5 * rnn)
        self.h2h = Linear(rnn, 5 * rnn)
        self.a2c = Linear(rnn, 2 * rnn)
        self.attention = _Attention(rnn, hid)

    def forward(self, xt, att, p_att, h, c):
        r = self.r
        att_res = self.attention(h, att, p_att)
        s = self.i2h(xt) + self.h2h(h)
        gates = torch.sigmoid(s[:, :3 * r])
        it = s[:, 3 * r:] + self.a2c(att_res)
        it = torch.maximum(it[:, :r], it[:, r:])
        c_new = gates[:, r:2 * r] * c + gates[:, :r] * it
        return gates[:, 2 * r:] * torch.tanh(c_new), c_new


class Att2In2(nn.Module):
    """The att2in2 decoder's teacher-forced masked NLL (dropout in train
    mode; no scheduled sampling)."""

    def __init__(self, m):
        super().__init__()
        v1 = m.cap_vocab_size + 1
        self.p = m.cap_drop_prob_lm
        self.rnn = m.cap_rnn_size
        self.embed = nn.Sequential(nn.Embedding(v1, m.cap_input_encoding_size))
        self.fc_embed = nn.Sequential(Linear(m.cap_fc_feat_size, self.rnn))
        self.att_embed = nn.Sequential(Linear(m.cap_att_feat_size, self.rnn))
        self.ctx2att = Linear(self.rnn, m.cap_att_hid_size)
        self.core = _Core(m.cap_input_encoding_size, self.rnn,
                          m.cap_att_hid_size)
        self.logit = Linear(self.rnn, v1)

    def _drop(self, x, g):
        if not self.training or self.p <= 0.0:
            return x
        return word_dropout(x, self.p, g)

    def nll(self, fc_feats, att_feats, seq, mask, g):
        b, t = seq.shape
        fc = self._drop(F.relu(self.fc_embed(fc_feats)), g)
        att = self._drop(F.relu(self.att_embed(att_feats)), g)
        p_att = self.ctx2att(att)
        h = fc.new_zeros((b, self.rnn))
        c = h
        outs = []
        for i in range(t - 1):
            xt = self._drop(F.relu(self.embed(seq[:, i].long())), g)
            h, c = self.core(xt, att, p_att, h, c)
            outs.append(self._drop(h, g))
        logps = torch.log_softmax(self.logit(torch.stack(outs, 1)), -1)
        target = seq[:, 1:].long()
        msk = mask[:, 1:1 + logps.shape[1]].float()
        nll = -torch.gather(logps, -1, target[..., None])[..., 0]
        return torch.sum(nll * msk) / torch.clamp(torch.sum(msk), min=1.0)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def anchor_targets(anchors, gt_boxes, gt_valid, im_h, im_w, generator, t):
    e, m = gt_boxes.shape[:2]
    n = anchors.shape[0]
    dev = anchors.device
    u_pos = _rand((e, n), generator, dev)
    u_neg = _rand((e, n), generator, dev)
    ih, iw = im_h.reshape(e, 1), im_w.reshape(e, 1)
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < iw) & (anchors[:, 3] < ih))
    iou = box_iou(anchors, gt_boxes[..., :4])
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    iou = torch.where(inside[..., None], iou, -1.0)
    argmax_gt = torch.argmax(iou, dim=2)
    max_iou = torch.amax(iou, dim=2)
    gt_max = torch.amax(iou, dim=1)
    is_gt_best = torch.any((iou == gt_max[:, None, :]) & gt_valid[:, None, :]
                           & (gt_max[:, None, :] > -1.0), dim=2) & inside
    neg = inside & (max_iou < t.rpn_negative_overlap)
    pos = inside & (is_gt_best | (max_iou >= t.rpn_positive_overlap))
    neg = neg & ~pos
    batch = t.rpn_batchsize
    num_fg = int(t.rpn_fg_fraction * batch)
    num_pos = torch.clamp(pos.sum(1), max=num_fg)
    kept = []
    for mask, u, budget, count in ((pos, u_pos, num_fg, num_pos),
                                   (neg, u_neg, batch, batch - num_pos)):
        k = min(budget, n)
        vals, idx = torch.sort(torch.where(mask, u, torch.inf), dim=1,
                               stable=True)
        keep = ((torch.arange(k, device=dev)[None, :] < count[:, None])
                & (vals[:, :k] != torch.inf))
        kept.append(torch.zeros_like(mask).scatter_(1, idx[:, :k], keep))
    labels = torch.where(kept[0], 1, torch.where(kept[1], 0, -1))
    matched = torch.gather(gt_boxes[..., :4], 1,
                           argmax_gt[..., None].expand(e, n, 4))
    tgt = torch.where(inside[..., None], encode_boxes(anchors[None], matched),
                      0.0)
    sampled = (labels >= 0).float()
    outside = sampled / torch.clamp(sampled.sum(1, keepdim=True), min=1.0)
    return labels, tgt, (labels == 1).float(), outside


def proposal_targets(rois, roi_valid, gt_boxes, gt_valid, gt_masks,
                     generator, t, mask_size: int):
    e, p = rois.shape[:2]
    m = gt_boxes.shape[1]
    r = t.roi_batch_size
    f = int(round(t.fg_fraction * r))
    dev = rois.device
    u_fg = _rand((e, p + m), generator, dev)
    u_bg = _rand((e, p + m), generator, dev)
    u_rep = _rand((e, r), generator, dev)
    cand = torch.cat([rois, gt_boxes[..., :4]], dim=1)
    is_gt = torch.arange(p + m, device=dev) >= p
    iou = torch.where(gt_valid[:, None, :], box_iou(cand, gt_boxes[..., :4]),
                      -1.0)
    max_iou = torch.amax(iou, dim=2)
    gt_assign = torch.argmax(iou, dim=2)
    cand_valid = torch.cat([roi_valid, gt_valid], dim=1)
    fg = cand_valid & (max_iou >= t.fg_thresh)
    bg = (cand_valid & (max_iou < t.bg_thresh_hi)
          & (max_iou >= t.bg_thresh_lo) & ~is_gt)
    if not t.use_gt:
        any_prop_fg = torch.any(fg & ~is_gt, dim=1, keepdim=True)
        fg = torch.where(is_gt, fg & ~any_prop_fg, fg)
    fg_count, bg_count = fg.sum(1), bg.sum(1)
    fg_by_rank = torch.sort(u_fg + (~fg).float() * _BIG, dim=1, stable=True).indices
    bg_by_rank = torch.sort(u_bg + (~bg).float() * _BIG, dim=1, stable=True).indices
    all_fg = (bg_count == 0) & (fg_count > 0)
    fg_take = torch.where(all_fg, r, torch.clamp(fg_count, max=f))
    slot = torch.arange(r, device=dev)[None, :]
    is_fg_slot = slot < fg_take[:, None]
    safe_fg = torch.clamp(fg_count, min=1)[:, None]
    safe_bg = torch.clamp(bg_count, min=1)[:, None]
    fg_src = torch.gather(fg_by_rank, 1, slot % safe_fg)
    bg_pos = slot - fg_take[:, None]
    bg_rand = torch.minimum(torch.floor(u_rep * safe_bg).long(), safe_bg - 1)
    bg_idx = torch.where((bg_count >= r - fg_take)[:, None],
                         torch.clamp(bg_pos, 0, p + m - 1) % safe_bg, bg_rand)
    sel = torch.where(is_fg_slot, fg_src, torch.gather(bg_by_rank, 1, bg_idx))
    out_rois = torch.gather(cand, 1, sel[..., None].expand(e, r, 4))
    out_valid = torch.where(is_fg_slot, torch.gather(fg, 1, sel),
                            torch.gather(bg, 1, sel))
    gt_idx = torch.gather(gt_assign, 1, sel)
    matched = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(e, r, 5))
    labels = torch.where(is_fg_slot & out_valid, matched[..., 4].long(), 0)
    means = torch.tensor(t.bbox_normalize_means, dtype=torch.float32,
                         device=dev)
    stds = torch.tensor(t.bbox_normalize_stds, dtype=torch.float32,
                        device=dev)
    bbox_w = (labels > 0).float()
    tgt = (encode_boxes(out_rois, matched[..., :4]) - means) / stds
    tgt = tgt * bbox_w[..., None]
    s = mask_size
    fr = torch.floor(out_rois[:, :f]).to(torch.int64)
    x1, y1, x2, y2 = fr.unbind(-1)
    t2 = 2 * torch.arange(s, device=dev) + 1
    mh, mw = gt_masks.shape[-2:]
    ys = torch.clamp(y1[..., None] + (t2 * (y2 - y1 + 1)[..., None])
                     // (2 * s), 0, mh - 1)
    xs = torch.clamp(x1[..., None] + (t2 * (x2 - x1 + 1)[..., None])
                     // (2 * s), 0, mw - 1)
    ei = torch.arange(e, device=dev)[:, None, None, None]
    mask_t = gt_masks[ei, gt_idx[:, :f, None, None], ys[..., :, None],
                      xs[..., None, :]].float()
    mask_w = (is_fg_slot[:, :f] & out_valid[:, :f]).float()
    return out_rois, labels, tgt, bbox_w, mask_t, mask_w, out_valid


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def smooth_l1(pred, target, inside_w, outside_w, sigma: float):
    s2 = sigma * sigma
    diff = torch.where(inside_w > 0, pred - target, 0.0) * inside_w
    a = torch.abs(diff)
    flag = (a < 1.0 / s2).float()
    per = flag * 0.5 * s2 * diff * diff + (1.0 - flag) * (a - 0.5 / s2)
    return torch.where(outside_w > 0, per * outside_w, 0.0)


def weighted_ce(logits, labels, weights):
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    ce = torch.where(weights > 0, ce, 0.0)
    return torch.sum(ce * weights) / torch.clamp(torch.sum(weights), min=1.0)


def bce_with_logits(logits, targets):
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def response_target(gt_mask, stride: int, h: int, w: int):
    return gt_mask.float()[..., stride // 2::stride,
                           stride // 2::stride][..., :h, :w]


def unpack_bits(packed):
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

class Reference(nn.Module):
    """The network under the reference's state-dict keys. `cfg` is the
    nested dict of a configuration file's `config`."""

    def __init__(self, cfg: Dict, precision: str = "float32"):
        super().__init__()
        self.cfg = c = namespace(cfg)
        m = c.model
        if not m.backbone.startswith("resnet") or m.pooling_mode != "crop" \
                or m.num_filters != 7 or c.test.mode != "nms":
            raise ValueError("the reference covers ResNet-C4 with the crop, "
                             "seven filters and test mode 'nms'")
        self.prec = Precision(precision)
        self.resnet = ResNetC4(m.backbone)
        self.rnn_encoder = RNNEncoder(m)
        self.filter_gen = DynamicFilterGen(m)
        a = len(m.anchor_scales) * len(m.anchor_ratios)
        self.rpn = RPNHead(m.c4_feat_dim, a)
        self.box = BoxHead(2048, m.num_classes)
        self.mask = MaskHead(2048, m.num_classes)
        self.caption_model = Att2In2(m) if m.use_caption_loss else None
        self.crop = crop_and_resize
        for mod in self.modules():
            if mod is not self:
                mod.prec = self.prec

    # state-dict keys as the measured network names them
    def load_reference_state(self, sd: Dict[str, torch.Tensor]) -> None:
        own = self.reference_state_keys()
        missing = set(own) - set(sd)
        if missing:
            raise KeyError(f"weights lack {sorted(missing)[:5]}")
        with torch.no_grad():
            for key, t in own.items():
                t.copy_(sd[key].to(t.dtype))

    def reference_state_keys(self) -> Dict[str, torch.Tensor]:
        out = {}
        for name, t in list(self.named_parameters()) + \
                list(self.named_buffers()):
            key = name
            for ours, theirs in (("filter_gen.", ""), ("rpn.", ""),
                                 ("box.", ""), ("mask.", "")):
                if key.startswith(ours):
                    key = theirs + key[len(ours):]
            out[key] = t
        return out

    def set_frozen(self) -> None:
        """requires_grad off for the stem and layer1..fixed_blocks."""
        mods = [self.resnet.conv1] + [getattr(self.resnet, f"layer{i}")
                                      for i in range(
                                          1, self.cfg.model.fixed_blocks + 1)]
        for mod in mods:
            for p in mod.parameters():
                p.requires_grad_(False)

    def _images(self, images):
        if images.dtype == torch.uint8:
            means = torch.tensor(self.cfg.data.pixel_means_bgr,
                                 dtype=torch.float32, device=images.device)
            return images.float() - means
        return images.float()

    def roi_tail(self, gated, rois):
        m = self.cfg.model
        crops = self.crop(gated, rois, m.pooling_size, 1.0 / m.feat_stride)
        e, r = crops.shape[:2]
        fc7 = self.resnet.tail(crops.reshape(e * r, *crops.shape[2:]))
        return fc7.reshape(e, r, *fc7.shape[1:])

    # ---------------- serving ----------------

    @torch.no_grad()
    def condition(self, images, labels):
        """(net_conv (N, h, w, C), gated (E, h, w, C), response (E, h, w,
        1)) for N images of E // N expressions each."""
        net_conv = self.resnet.head(self._images(images))
        hidden = self.rnn_encoder(labels)
        gated, response = self.filter_gen(
            net_conv, hidden, labels.shape[0] // net_conv.shape[0])
        return net_conv, gated, response

    @torch.no_grad()
    def rpn_outputs(self, gated):
        cls, box = self.rpn(gated)
        e, h, w, a, _ = cls.shape
        n = h * w * a
        return (torch.softmax(cls.reshape(e, n, 2), -1)[..., 1],
                box.reshape(e, n, 4), (h, w))

    @torch.no_grad()
    def box_outputs(self, gated, rois, chunk: int = 16):
        """cls_score (E, R, K) and de-normalized bbox_pred (E, R, 4K) on
        given rois, `chunk` expressions at a time."""
        c = self.cfg
        scores, deltas = [], []
        for e0 in range(0, rois.shape[0], chunk):
            fc7 = self.roi_tail(gated[e0:e0 + chunk], rois[e0:e0 + chunk])
            e, r = fc7.shape[:2]
            s, d = self.box(fc7.reshape(e * r, *fc7.shape[2:]))
            scores.append(s.reshape(e, r, -1))
            deltas.append(d.reshape(e, r, -1))
        stds = torch.tensor(c.train.bbox_normalize_stds, device=rois.device)
        means = torch.tensor(c.train.bbox_normalize_means, device=rois.device)
        k = c.model.num_classes
        bbox = torch.cat(deltas).reshape(rois.shape[0], rois.shape[1], k, 4)
        return torch.cat(scores), (bbox * stds + means).reshape(
            rois.shape[0], rois.shape[1], -1)

    @torch.no_grad()
    def mask_probs(self, gated, boxes, labels):
        """(E, B, S, S) mask probabilities of given boxes and classes."""
        fc7 = self.roi_tail(gated, boxes)
        e, b = fc7.shape[:2]
        sel = self.mask(fc7.reshape(e * b, *fc7.shape[2:]),
                        labels.reshape(e * b))
        s = self.cfg.model.mask_size
        return torch.sigmoid(sel.reshape(e, b, s, s))

    @torch.no_grad()
    def test_forward(self, images, im_hw, labels):
        """The whole test-mode forward: the rois and their scores and
        deltas, the response and the gated map."""
        c = self.cfg
        _, gated, response = self.condition(images, labels)
        score_pos, deltas, (h, w) = self.rpn_outputs(gated)
        e = labels.shape[0]
        hw = im_hw.float()[:, None, :].expand(
            im_hw.shape[0], e // im_hw.shape[0], 2).reshape(e, 2)
        anchors = shifted_anchors(h, w, c.model.feat_stride,
                                  c.model.anchor_scales,
                                  c.model.anchor_ratios, gated.device)
        props = proposal_layer(score_pos, deltas, anchors, hw[:, 0], hw[:, 1],
                               c.test.rpn_pre_nms_top_n,
                               c.test.rpn_post_nms_top_n,
                               c.test.rpn_nms_thresh)
        cls_score, bbox_pred = self.box_outputs(gated, props.rois)
        return {"rois": props.rois, "roi_valid": props.valid,
                "cls_score": cls_score, "bbox_pred": bbox_pred,
                "response": response, "gated": gated,
                "score_pos": score_pos, "deltas": deltas, "anchors": anchors,
                "im_hw": hw}

    # ---------------- training ----------------

    def train_forward(self, batch, generator, proposals=None):
        """The losses of one batch. `proposals` (rois, valid) stands in for
        the RPN's NMS output (the program's discrete choice, which the
        check follows); None runs the reference's own."""
        c = self.cfg
        m, t = c.model, c.train
        images = self._images(batch["images"])
        img_idx = batch["img_idx"].long()
        e = img_idx.shape[0]
        gt_boxes = batch["gt_boxes"].float()
        if gt_boxes.dim() == 2:
            gt_boxes = gt_boxes[:, None, :]
        gt_masks = batch["gt_masks"]
        if gt_masks.dim() == 3:
            gt_masks = gt_masks[:, None]
        if gt_masks.shape[-1] * 8 == images.shape[2]:
            gt_masks = unpack_bits(gt_masks)
        gt_valid = torch.ones(gt_boxes.shape[:2], dtype=torch.bool,
                              device=gt_boxes.device)
        net_conv = self.resnet.head(images).index_select(0, img_idx)
        hidden = self.rnn_encoder(batch["labels"], generator)
        gated, response = self.filter_gen(net_conv, hidden)
        rpn_cls, rpn_box = self.rpn(gated)
        _, h, w, a, _ = rpn_cls.shape
        n = h * w * a
        anchors = shifted_anchors(h, w, m.feat_stride, m.anchor_scales,
                                  m.anchor_ratios, gated.device)
        im_hw = batch["im_hw"].float().index_select(0, img_idx)
        at = anchor_targets(anchors, gt_boxes, gt_valid, im_hw[:, 0],
                            im_hw[:, 1], generator, t)
        if proposals is None:
            with torch.no_grad():
                sp = torch.softmax(rpn_cls.reshape(e, n, 2), -1)[..., 1]
                props = proposal_layer(sp, rpn_box.reshape(e, n, 4), anchors,
                                       im_hw[:, 0], im_hw[:, 1],
                                       t.rpn_pre_nms_top_n,
                                       t.rpn_post_nms_top_n, t.rpn_nms_thresh)
            proposals = (props.rois, props.valid)
            if getattr(self, "_capture", None) is not None:
                self._capture.update(
                    score_pos=sp, deltas=rpn_box.detach().reshape(e, n, 4),
                    anchors=anchors, im_h=im_hw[:, 0], im_w=im_hw[:, 1],
                    rois=props.rois, valid=props.valid)
        rois, lab, btgt, bw, mtgt, mw, rvalid = proposal_targets(
            proposals[0], proposals[1], gt_boxes, gt_valid,
            gt_masks.to(torch.uint8), generator, t, m.mask_size)
        labels_a, tgt_a, in_a, out_a = at
        losses = {
            "rpn_cross_entropy": weighted_ce(
                rpn_cls.reshape(e, n, 2), torch.clamp(labels_a, min=0),
                (labels_a >= 0).float()),
            "rpn_loss_box": torch.sum(smooth_l1(
                rpn_box.reshape(e, n, 4), tgt_a, in_a[..., None],
                out_a[..., None], 3.0)) / e}
        fc7 = self.roi_tail(gated, rois)
        r = fc7.shape[1]
        cls_score, bbox_pred = self.box(fc7.reshape(e * r, *fc7.shape[2:]))
        losses["cross_entropy"] = weighted_ce(cls_score.reshape(e, r, -1),
                                              lab, rvalid.float())
        sel = torch.gather(bbox_pred.reshape(e, r, m.num_classes, 4), 2,
                           lab[..., None, None].expand(e, r, 1, 4))[:, :, 0]
        losses["loss_box"] = torch.sum(smooth_l1(
            sel, btgt, bw[..., None], bw[..., None], 1.0)) / (e * r)
        f = mtgt.shape[1]
        s = m.mask_size
        fg = fc7[:, :f]
        logits = self.mask(fg.reshape(e * f, *fg.shape[2:]),
                           torch.clamp(lab[:, :f], 0,
                                       m.num_classes - 1).reshape(e * f))
        bce = bce_with_logits(logits.reshape(e, f, s, s), mtgt)
        mwb = mw[:, :, None, None]
        bce = torch.where(mwb > 0, bce, 0.0)
        losses["loss_mask"] = torch.sum(bce * mwb) / (
            torch.clamp(torch.sum(mw), min=1.0) * s * s)
        if m.use_response_loss:
            stride = m.feat_stride
            tgt = response_target(gt_masks[:, 0], stride, h, w)
            ys = torch.arange(h, device=gated.device)[None, :, None] * stride
            xs = torch.arange(w, device=gated.device)[None, None, :] * stride
            vmask = ((ys < im_hw[:, 0, None, None])
                     & (xs < im_hw[:, 1, None, None])).float()
            rb = bce_with_logits(response[..., 0], tgt)
            losses["loss_response"] = torch.sum(rb * vmask) / torch.clamp(
                torch.sum(vmask), min=1.0)
        if self.caption_model is not None:
            feats_b = gated if m.response_gate == "sigmoid" else None
            fc5a = self.resnet.tail(net_conv)
            fc5b = self.resnet.tail(feats_b)
            fc = torch.cat([fc5a.mean(dim=(1, 2)), fc5b.mean(dim=(1, 2))], -1)
            att = torch.cat([_pool14(fc5a), _pool14(fc5b)], -1)
            losses["loss_caption"] = m.cap_loss_weight * self.caption_model.nll(
                fc, att.reshape(att.shape[0], 196, -1), batch["cap_labels"],
                batch["cap_masks"], generator)
        losses["total_loss"] = sum(losses.values())
        return losses


def _pool14(x):
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), 14).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# selection, paste-back and SGD
# ---------------------------------------------------------------------------

def select_boxes(rois, deltas, scores, valid, scale, ih, iw):
    """Per sentence the global argmax over scores[:, :, 1:] of the valid
    rois: (box in original-image coordinates (S, 4), roi index, class)."""
    s, r, _ = rois.shape
    k = scores.shape[-1]
    scale, ih, iw = (v.reshape(-1, 1, 1) for v in (scale, ih, iw))
    pk = decode_boxes(rois / scale, deltas).reshape(s, r, k, 4)
    lim = torch.stack([iw, ih, iw, ih], dim=-1) - 1.0
    pk = torch.minimum(torch.clamp(pk, min=0.0), lim)
    sc = torch.where(valid[..., None], scores, torch.full_like(scores, -1.0))
    idx = torch.argmax(sc[:, :, 1:].reshape(s, -1), dim=1)
    r_idx, cls = idx // (k - 1), idx % (k - 1) + 1
    return pk[torch.arange(s, device=rois.device), r_idx, cls], r_idx, cls


def paste_iou(mask_probs, boxes, gt_masks, sh, sw, ih, iw, oh: int,
              ow: int):
    """Each sentence's (I, U) pixel counts: its S x S mask probabilities
    resized bilinearly (half-pixel centres) into its int-truncated,
    clipped box on an (oh, ow) canvas, cut at 122/255, against its GT mask
    nearest-resized from the scaled extent (sh, sw) to (ih, iw)."""
    s, m, _ = mask_probs.shape
    dev = mask_probs.device
    hi_x, hi_y = (iw - 1).float(), (ih - 1).float()

    def corner(v, hi):
        return torch.clamp(torch.clamp(v, min=0.0), max=hi).to(torch.int32)

    x1, y1 = corner(boxes[:, 0], hi_x), corner(boxes[:, 1], hi_y)
    x2, y2 = corner(boxes[:, 2], hi_x), corner(boxes[:, 3], hi_y)

    def weights(p0, extent, size):
        pos = torch.arange(size, dtype=torch.float32, device=dev)[None]
        p = pos - p0[:, None].float()
        src = (p + 0.5) * m / extent[:, None] - 0.5
        s0 = torch.clamp(torch.floor(src), 0, m - 1).long()
        s1 = torch.clamp(s0 + 1, max=m - 1)
        frac = torch.clamp(src - s0.float(), 0.0, 1.0)
        k = torch.arange(m, device=dev)[None, None, :]
        wm = ((1.0 - frac)[..., None] * (k == s0[..., None])
              + frac[..., None] * (k == s1[..., None]))
        return wm * ((p >= 0) & (p < extent[:, None]))[..., None]

    wy = weights(y1, (y2 - y1 + 1).float(), oh)
    wx = weights(x1, (x2 - x1 + 1).float(), ow)
    pred = torch.bmm(torch.bmm(wy, mask_probs.float()),
                     wx.transpose(1, 2)) * 255.0 > 122.0
    ys = ((2 * torch.arange(oh, device=dev) + 1)[None] * sh[:, None]
          // (2 * torch.clamp(ih, min=1))[:, None])
    xs = ((2 * torch.arange(ow, device=dev) + 1)[None] * sw[:, None]
          // (2 * torch.clamp(iw, min=1))[:, None])
    ys = torch.clamp(ys, 0, gt_masks.shape[1] - 1).expand(s, oh)
    xs = torch.clamp(xs, 0, gt_masks.shape[2] - 1).expand(s, ow)
    rows = torch.gather(gt_masks, 1, ys[:, :, None].expand(
        s, oh, gt_masks.shape[2]))
    gt = torch.gather(rows, 2, xs[:, None, :].expand(s, oh, ow)) > 0
    valid = ((torch.arange(oh, device=dev)[None, :, None] < ih[:, None, None])
             & (torch.arange(ow, device=dev)[None, None, :]
                < iw[:, None, None]))
    return ((pred & gt & valid).sum((1, 2)),
            ((pred | gt) & valid).sum((1, 2)))


def param_groups(named: Sequence[Tuple[str, torch.Tensor]], t
                 ) -> List[Dict]:
    """(lr multiplier, weight decay) groups of the trainable parameters
    under their state-dict keys, as the configuration states them."""
    groups: Dict[Tuple[float, float], Dict] = {}
    for name, p in named:
        if not p.requires_grad:
            continue
        mult = t.lang_lr_mult if name.startswith(LANG_PREFIXES) else 1.0
        bias = name.rsplit(".", 1)[-1].startswith("bias") and \
            name not in CAPTIONER_RAW_BIASES
        if bias and t.double_bias:
            mult *= 2.0
        decay = 0.0 if bias and not t.bias_decay else t.weight_decay
        g = groups.setdefault((mult, decay), {"mult": mult, "decay": decay,
                                              "params": [], "names": []})
        g["params"].append(p)
        g["names"].append(name)
    return list(groups.values())


class PlainSGD:
    """Momentum SGD by groups: the gradients clipped to a global L2 norm
    of `clip` (when above 0), then buf = momentum * buf + (grad + decay *
    p), p -= lr * mult * buf (the first buf is the decayed gradient)."""

    def __init__(self, groups: List[Dict], lr: float, momentum: float,
                 clip: float = 0.0):
        self.groups, self.lr, self.momentum = groups, lr, momentum
        self.clip = clip
        self.buf: Dict[int, torch.Tensor] = {}

    @torch.no_grad()
    def clip_grads(self) -> None:
        """Zero gradients for parameters the step did not reach, then the
        global-norm clip: the gradients as the update takes them."""
        params = [p for g in self.groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip > 0:
            norm = torch.sqrt(sum(torch.sum(p.grad.double() ** 2)
                                  for p in params)).float()
            if norm >= self.clip:
                for p in params:
                    p.grad.mul_(self.clip / norm)

    @torch.no_grad()
    def update(self) -> None:
        for g in self.groups:
            for p in g["params"]:
                d = p.grad + g["decay"] * p if g["decay"] else p.grad.clone()
                b = self.buf.get(id(p))
                b = d if b is None else b.mul_(self.momentum).add_(d)
                self.buf[id(p)] = b
                p.add_(b, alpha=-self.lr * g["mult"])

    def step(self) -> None:
        self.clip_grads()
        self.update()


# ---------------------------------------------------------------------------
# the frozen statistics of the weights the benchmark draws
# ---------------------------------------------------------------------------

BRANCH_SCALE = 0.25   # the weight of each bottleneck's last BatchNorm


def frozen_statistics(sd: Dict, cfg: Dict, seed: int, device) -> None:
    """Frozen BatchNorm statistics that give every backbone convolution's
    output unit scale, as a trained network's statistics do: one f32
    pass of the backbone (head and layer4) over an image of N(0, 30^2)
    pixels drawn from `seed`, each BN's `running_var` set, just before it
    applies, to its input's mean square rounded to a power of 4 (so its
    scale is a power of 2, exact in any float type) and its mean to 0;
    each bottleneck's last BN weighs its branch by `BRANCH_SCALE`, so the
    residual stream grows slowly, as in a trained ResNet. Writes into
    `sd`."""
    d = cfg["data"]
    with torch.device("meta"):
        net = ResNetC4(cfg["model"]["backbone"])
    net = net.to_empty(device=device)
    own = {f"resnet.{k}": v for k, v in net.state_dict().items()}
    net.load_state_dict({k[len("resnet."):]: sd[k] for k in own})
    hooks = []
    for name, mod in net.named_modules():
        if not isinstance(mod, FrozenBatchNorm):
            continue
        key = f"resnet.{name}"
        if name.endswith("bn3"):
            for v in (mod.weight, sd[f"{key}.weight"]):
                v.fill_(BRANCH_SCALE)

        def fit(mod, inputs, key=key):
            m2 = float(inputs[0].double().pow(2).mean())
            var = 4.0 ** round(math.log(max(m2, 1e-12), 4))
            for v in (mod.running_var, sd[f"{key}.running_var"]):
                v.fill_(var)
            for v in (mod.running_mean, sd[f"{key}.running_mean"]):
                v.zero_()

        hooks.append(mod.register_forward_pre_hook(fit))
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    image = torch.randn((1, d["canvas_h"], d["canvas_w"], 3), generator=g,
                        device=device) * 30.0
    with torch.no_grad():
        net.tail(net.head(image))
    for h in hooks:
        h.remove()
