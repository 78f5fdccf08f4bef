"""Fused language-conditioned gate and its gradient: the hand-written
CUDA kernels (`csrc/fused_filter.cu`) for CUDA tensors, their plain
PyTorch versions for CPU tensors.

Replaces the TPU kernel `lang2seg_tpu/ops/pallas_kernels.py::
fused_dynamic_filter`, a `jax.custom_vjp`: its Pallas forward and its
gradient rule `_fdf_bwd`. `fused_dynamic_filter` is differentiable on
both devices through `FusedDynamicFilter`, whose backward is the second
kernel. Both versions follow the Pallas kernel's arithmetic, not the
plain JAX path of `models/dynamic_filter.py`: the response is scaled by
the f32 constant 1/sqrt(C) (not divided by sqrt(C)), and the gated map
is the f32 product conv * g rounded once to the map's dtype (not a
product of g cast to the map's dtype); the backward recomputes the
response and rounds d_conv once to the map's dtype, as `_fdf_bwd` does.
On the card the bf16 forward takes its f32 products on the tensor cores,
the filter split into a hi and a lo bf16 part. `tile_plan` is how the
wrapper cuts a map into persistent blocks for both kernels, from the
tiling each kernel reports (`fused_filter_tiling`); `plans` keeps the plan
of each kernel's last launch. Their launches count `gate.launches` and
`gate.bwd_launches` (`utils/trace.py`). The forward reads one map per
`exprs_per_map` consecutive expressions (an eval dispatch of N images x
S expressions reads each image's map in place, S = exprs_per_map); the
backward takes one map an expression (or one map for all of them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ..utils.trace import count, span
from . import _build

plans: Dict[str, Dict[str, object]] = {}


def per_expression(net_conv: torch.Tensor, exprs_per_map: int
                   ) -> torch.Tensor:
    """The (E, H, W, C) map of each expression from (E // G, H, W, C) maps,
    G = exprs_per_map consecutive expressions reading each: a stride-0 view
    of a single map, a copy of several."""
    if exprs_per_map == 1:
        return net_conv
    n = net_conv.shape[0]
    return net_conv[:, None].expand(n, exprs_per_map, *net_conv.shape[1:]
                                    ).reshape(n * exprs_per_map,
                                              *net_conv.shape[1:])


def fused_dynamic_filter_plain(net_conv: torch.Tensor, filt: torch.Tensor,
                               rfilt: torch.Tensor, num_filters: int = 7,
                               gate: str = "sigmoid", normalize: bool = False,
                               exprs_per_map: int = 1
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """net_conv (E // G, H, W, C), expression e reading map e // G (G =
    exprs_per_map); filt (E, C, K) f32; rfilt (E, K) f32. Returns (gated
    (E, H, W, C) in net_conv's dtype, response (E, H, W, 1) f32)."""
    from ..models.dynamic_filter import spatial_masks_7
    net_conv = per_expression(net_conv, exprs_per_map)
    e, h, w, c = net_conv.shape
    k = num_filters
    x = net_conv.float()
    resp = torch.matmul(x.reshape(e, h * w, c), filt.float())
    resp = resp.reshape(e, h, w, k)
    if normalize:
        resp = resp * (1.0 / (c ** 0.5))
    if k == 7:
        masks = spatial_masks_7(h, w, device=net_conv.device)
        resp = resp * masks.permute(1, 2, 0)[None]
        fused = torch.sum(resp * rfilt.float()[:, None, None, :], dim=-1,
                          keepdim=True)
    else:
        fused = resp
    g = torch.sigmoid(fused) if gate == "sigmoid" else fused
    return (x * g).to(net_conv.dtype), fused


def fused_dynamic_filter_bwd_plain(net_conv: torch.Tensor, filt: torch.Tensor,
                                   rfilt: torch.Tensor, fused: torch.Tensor,
                                   d_gated: torch.Tensor, d_resp: torch.Tensor,
                                   num_filters: int = 7,
                                   gate: str = "sigmoid",
                                   normalize: bool = False
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The gradient rule `_fdf_bwd` in torch ops: given the forward's
    inputs, its response `fused` (E, H, W, 1) f32 and the cotangents of
    its two outputs, returns (d_conv in net_conv's dtype, rounded once,
    d_filt (E, C, K) f32, d_rfilt (E, K) f32; zero for K=1)."""
    from ..models.dynamic_filter import spatial_masks_7
    e, h, w, c = net_conv.shape
    k = num_filters
    conv32 = net_conv.float()
    d_gated32 = d_gated.float()
    scale = 1.0 / (c ** 0.5) if normalize else 1.0
    if gate == "sigmoid":
        g = torch.sigmoid(fused)
        g_prime = g * (1.0 - g)
    else:
        g = fused
        g_prime = torch.ones_like(fused)
    d_conv = d_gated32 * g
    d_g = torch.sum(d_gated32 * conv32, dim=-1, keepdim=True)
    d_fused = d_resp.float() + d_g * g_prime                   # (E, H, W, 1)
    if k == 7:
        mask = spatial_masks_7(h, w, device=net_conv.device).permute(
            1, 2, 0)[None]                                      # (1, H, W, 7)
        resp0 = torch.einsum("ehwc,eck->ehwk", conv32, filt) * scale
        d_rfilt = torch.einsum("ehwk,ehw->ek", resp0 * mask, d_fused[..., 0])
        d_resp0 = d_fused * rfilt[:, None, None, :] * mask
    else:
        d_rfilt = torch.zeros_like(rfilt)
        d_resp0 = d_fused
    d_conv = d_conv + torch.einsum("ehwk,eck->ehwc", d_resp0, filt) * scale
    d_filt = torch.einsum("ehwc,ehwk->eck", conv32, d_resp0) * scale
    return d_conv.to(net_conv.dtype), d_filt, d_rfilt


def _bind(lib):
    """Declare the C entries' argument types on a loaded library built from
    `csrc/fused_filter.cu` (the port's or a variant)."""
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.fused_filter_grouped_launch.argtypes = [
        p, ctypes.c_longlong, i, p, p, i, i, i, i, i, i, i, ctypes.c_float,
        i, p, p, p]
    lib.fused_filter_grouped_launch.restype = ctypes.c_int
    lib.fused_filter_bwd_launch.argtypes = [
        p, ctypes.c_longlong, p, p, p, p, p, i, i, i, i, i, i, i,
        ctypes.c_float, i, p, p, p, p, p, p]
    lib.fused_filter_bwd_launch.restype = ctypes.c_int
    lib.fused_filter_tiling.argtypes = [i, i, i, p]
    lib.fused_filter_tiling.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    return _bind(_build.load("fused_filter"))


@functools.lru_cache(maxsize=None)
def _tiling(backward: bool, c: int, is_bf16: bool) -> Tuple[int, int]:
    """(pixels a tile, blocks an SM) of the kernel the C entry takes for
    maps of c channels, as the library reports them."""
    out = (ctypes.c_int * 2)()
    rc = _lib().fused_filter_tiling(int(backward), c, int(is_bf16), out)
    if rc != 0:
        raise ValueError(f"fused_dynamic_filter: unsupported C={c} for "
                         f"{'bfloat16' if is_bf16 else 'float32'}")
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_plan(e: int, h: int, w: int, tile_pixels: int, blocks_per_sm: int,
              sms: int) -> Dict[str, object]:
    """How a kernel walking tiles of `tile_pixels` pixels covers an (e, h,
    w) map: each expression's tiles split into runs of `tiles_per_block`
    consecutive tiles, one persistent block a run, on a grid of
    (blocks_per_expr, e) blocks: `blocks_per_sm` blocks an SM, in one wave
    while e <= blocks_per_sm * sms. Block b of expression i covers pixels
    [b * tiles_per_block * tile_pixels, ...) up to the next block's first
    pixel or h * w. The backward writes one (c, k) d_filt partial and k
    d_rfilt partials a block, (e, blocks_per_expr, c, k) and (e,
    blocks_per_expr, k) in all, summed in block order by its second
    kernel."""
    tiles = -(-(h * w) // tile_pixels)
    blocks = max(1, min(tiles, blocks_per_sm * sms // e))
    per_block = -(-tiles // blocks)
    blocks = -(-tiles // per_block)                 # no block left empty
    return {"tile_pixels": tile_pixels, "tiles_per_expr": tiles,
            "tiles_per_block": per_block, "blocks_per_expr": blocks,
            "grid": (blocks, e)}


def launch_plan(kernel: str, net_conv: torch.Tensor,
                exprs_per_map: int = 1) -> Dict[str, object]:
    """The plan `kernel` ("forward" or "backward") is launched with for
    the CUDA maps `net_conv`, each read by `exprs_per_map` expressions, on
    their card. Raises ValueError for a shape or C the kernels do not
    take; the launch checks the rest."""
    if net_conv.dim() != 4:
        raise ValueError("fused_dynamic_filter: net_conv must be (E, H, W, "
                         "C)")
    n, h, w, c = net_conv.shape
    e = n * exprs_per_map
    tp, per_sm = _tiling(kernel == "backward", c,
                         net_conv.dtype == torch.bfloat16)
    return tile_plan(e, h, w, tp, per_sm, _sms(net_conv.device.index))


def _check_inputs(net_conv, filt, rfilt, num_filters, gate, what,
                  exprs_per_map=1):
    """Raise unless the kernels take these inputs, expression e reading
    map e // exprs_per_map; returns the maps' batch stride in elements."""
    if gate not in ("sigmoid", "multiply"):
        raise ValueError(f"{what}: unknown gate {gate!r}")
    if net_conv.dim() != 4 or net_conv.dtype not in (torch.bfloat16,
                                                     torch.float32):
        raise ValueError(f"{what}: net_conv must be (E, H, W, C) bfloat16 "
                         f"or float32")
    n, h, w, c = net_conv.shape
    e = n * exprs_per_map
    k = num_filters
    per_vec = 8 if net_conv.dtype == torch.bfloat16 else 4
    nv = c // (32 * per_vec)
    if k not in (1, 7) or c % (32 * per_vec) or nv not in (
            (1, 2, 4) if per_vec == 8 else (1, 2, 4, 8)):
        raise ValueError(f"{what}: unsupported C={c}, K={k} for "
                         f"{net_conv.dtype}")
    s0, s1, s2, s3 = net_conv.stride()
    if (s1, s2, s3) != (w * c, c, 1):
        raise ValueError(f"{what}: each (H, W, C) map must be contiguous")
    if net_conv.data_ptr() % 16 or (s0 * net_conv.element_size()) % 16:
        raise ValueError(f"{what}: net_conv must be 16-byte aligned")
    for name, t, shape in (("filt", filt, (e, c, k)),
                           ("rfilt", rfilt, (e, k))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != net_conv.device):
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"{shape} on the map's device")
    return s0


@span("l2s.gate")
def _forward(net_conv, filt, rfilt, num_filters, gate, normalize,
             exprs_per_map=1):
    """The forward on the map's device: the plain version for a CPU
    tensor, the kernel on the current stream for a CUDA tensor."""
    if net_conv.device.type == "cpu":
        return fused_dynamic_filter_plain(net_conv, filt, rfilt, num_filters,
                                          gate, normalize, exprs_per_map)
    if net_conv.device.type != "cuda":
        raise ValueError(f"fused_dynamic_filter: unsupported device "
                         f"{net_conv.device}")
    plan = launch_plan("forward", net_conv, exprs_per_map)
    out = _launch_forward(_lib(), plan["blocks_per_expr"], net_conv, filt,
                          rfilt, num_filters, gate, normalize, exprs_per_map)
    plans["forward"] = plan
    return out


def _launch_forward(lib, blocks, net_conv, filt, rfilt, num_filters, gate,
                    normalize, exprs_per_map=1):
    """Check CUDA inputs and launch `lib`'s forward with `blocks` blocks
    per expression on the current stream, expression e reading map
    e // exprs_per_map."""
    s0 = _check_inputs(net_conv, filt, rfilt, num_filters, gate,
                       "fused_dynamic_filter", exprs_per_map)
    _, h, w, c = net_conv.shape
    e = filt.shape[0]
    k = num_filters
    gated = torch.empty((e, h, w, c), dtype=net_conv.dtype,
                        device=net_conv.device)
    resp = torch.empty((e, h, w, 1), dtype=torch.float32,
                       device=net_conv.device)
    scale = 1.0 / (c ** 0.5) if normalize else 1.0
    stream = torch.cuda.current_stream(net_conv.device).cuda_stream
    args = (filt.data_ptr(), rfilt.data_ptr(), e, h, w, c, k,
            int(net_conv.dtype == torch.bfloat16), int(gate == "sigmoid"),
            scale)
    out = (gated.data_ptr(), resp.data_ptr(), stream)
    rc = lib.fused_filter_grouped_launch(
        net_conv.data_ptr(), s0, exprs_per_map, *args, blocks, *out)
    if rc != 0:
        raise RuntimeError(f"fused_filter kernel launch failed: cudaError "
                           f"{rc}")
    count("gate.launches")
    return gated, resp


@span("l2s.gate")
def fused_dynamic_filter_bwd(net_conv: torch.Tensor, filt: torch.Tensor,
                             rfilt: torch.Tensor, fused: torch.Tensor,
                             d_gated: torch.Tensor, d_resp: torch.Tensor,
                             num_filters: int = 7, gate: str = "sigmoid",
                             normalize: bool = False, exprs_per_map: int = 1
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """See `fused_dynamic_filter_bwd_plain`. A CPU tensor takes the plain
    version; a CUDA tensor launches the backward kernel and its fixed-order
    reduction on the current stream, or raises. On the card the inputs
    follow the forward's rules; d_gated is a contiguous map of
    net_conv's dtype, fused and d_resp contiguous (E, H, W, 1) f32.
    Expressions read one map each (a stride-0 map for one read by all);
    maps shared by some of them (exprs_per_map > 1) raise."""
    if exprs_per_map != 1:
        raise NotImplementedError(
            f"fused_dynamic_filter_bwd: maps shared by {exprs_per_map} of "
            f"{filt.shape[0]} expressions have no backward yet (ROADMAP "
            f"Queue 1 #5.5: the training gather's in-place read); one map "
            f"for all goes in as a stride-0 map")
    if net_conv.device.type == "cpu":
        return fused_dynamic_filter_bwd_plain(
            net_conv, filt, rfilt, fused, d_gated, d_resp, num_filters, gate,
            normalize)
    if net_conv.device.type != "cuda":
        raise ValueError(f"fused_dynamic_filter_bwd: unsupported device "
                         f"{net_conv.device}")
    plan = launch_plan("backward", net_conv)
    out = _launch_backward(_lib(), plan["blocks_per_expr"], net_conv, filt,
                           rfilt, fused, d_gated, d_resp, num_filters, gate,
                           normalize)
    plans["backward"] = plan
    return out


def _launch_backward(lib, blocks, net_conv, filt, rfilt, fused, d_gated,
                     d_resp, num_filters, gate, normalize):
    """Check CUDA inputs and launch `lib`'s backward with `blocks` blocks
    per expression (and its reduction) on the current stream."""
    s0 = _check_inputs(net_conv, filt, rfilt, num_filters, gate,
                       "fused_dynamic_filter_bwd")
    e, h, w, c = net_conv.shape
    k = num_filters
    if (d_gated.dtype != net_conv.dtype or d_gated.shape != net_conv.shape
            or not d_gated.is_contiguous() or d_gated.data_ptr() % 16
            or d_gated.device != net_conv.device):
        raise ValueError("fused_dynamic_filter_bwd: d_gated must be a "
                         "contiguous 16-byte aligned map of net_conv's "
                         "shape and dtype")
    for name, t in (("fused", fused), ("d_resp", d_resp)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (e, h, w, 1)
                or not t.is_contiguous() or t.device != net_conv.device):
            raise ValueError(f"fused_dynamic_filter_bwd: {name} must be a "
                             f"contiguous float32 {(e, h, w, 1)}")
    dev = net_conv.device
    d_conv = torch.empty((e, h, w, c), dtype=net_conv.dtype, device=dev)
    d_filt = torch.empty((e, c, k), dtype=torch.float32, device=dev)
    d_rfilt = torch.empty((e, k), dtype=torch.float32, device=dev)
    filt_part = torch.empty((e, blocks, c, k), dtype=torch.float32,
                            device=dev)
    rfilt_part = torch.empty((e, blocks, k), dtype=torch.float32, device=dev)
    scale = 1.0 / (c ** 0.5) if normalize else 1.0
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_filter_bwd_launch(
        net_conv.data_ptr(), s0, d_gated.data_ptr(), filt.data_ptr(),
        rfilt.data_ptr(), fused.data_ptr(), d_resp.data_ptr(), e, h, w, c, k,
        int(net_conv.dtype == torch.bfloat16), int(gate == "sigmoid"), scale,
        blocks, filt_part.data_ptr(), rfilt_part.data_ptr(), d_conv.data_ptr(),
        d_filt.data_ptr(), d_rfilt.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_filter backward kernel launch failed: "
                           f"cudaError {rc}")
    count("gate.bwd_launches")
    return d_conv, d_filt, d_rfilt


class FusedDynamicFilter(torch.autograd.Function):
    """The gate as an autograd node: forward as `fused_dynamic_filter`,
    saving (net_conv, filt, rfilt, fused) as `_fdf_fwd` does; backward
    through `fused_dynamic_filter_bwd` (the kernel on a card)."""

    @staticmethod
    def forward(ctx, net_conv, filt, rfilt, num_filters, gate, normalize,
                exprs_per_map):
        gated, fused = _forward(net_conv, filt, rfilt, num_filters, gate,
                                normalize, exprs_per_map)
        ctx.save_for_backward(net_conv, filt, rfilt, fused)
        ctx.args = (num_filters, gate, normalize, exprs_per_map)
        return gated, fused

    @staticmethod
    def backward(ctx, d_gated, d_resp):
        net_conv, filt, rfilt, fused = ctx.saved_tensors
        d_conv, d_filt, d_rfilt = fused_dynamic_filter_bwd(
            net_conv, filt, rfilt, fused, d_gated.contiguous(),
            d_resp.contiguous(), *ctx.args)
        return d_conv, d_filt, d_rfilt, None, None, None, None


def fused_dynamic_filter(net_conv: torch.Tensor, filt: torch.Tensor,
                         rfilt: torch.Tensor, num_filters: int = 7,
                         gate: str = "sigmoid", normalize: bool = False,
                         exprs_per_map: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """See `fused_dynamic_filter_plain`; differentiable in all three
    tensors (in net_conv only when each map serves one expression, or one
    map all of them). A CPU tensor takes the plain versions; a CUDA tensor
    launches the kernels on the current stream, or raises. On the card
    net_conv is bf16 or f32, and each (H, W, C) map must be contiguous;
    the map stride may be 0 (a broadcast map is read in place, never
    copied), and each map is read in place by its `exprs_per_map`
    expressions. One map for all expressions goes in as the stride-0
    broadcast."""
    if exprs_per_map < 1 or net_conv.shape[0] * exprs_per_map != \
            filt.shape[0]:
        raise ValueError(f"fused_dynamic_filter: {net_conv.shape[0]} maps "
                         f"of {exprs_per_map} expressions each for "
                         f"{filt.shape[0]} filters")
    if net_conv.shape[0] == 1 and exprs_per_map > 1:
        net_conv = net_conv.expand(exprs_per_map, *net_conv.shape[1:])
        exprs_per_map = 1
    return FusedDynamicFilter.apply(net_conv, filt, rfilt, num_filters, gate,
                                    normalize, exprs_per_map)
