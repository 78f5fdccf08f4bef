"""Frozen BatchNorm, residual and ReLU in one pass: the hand-written CUDA
kernels (`csrc/bn_act.cu`) for CUDA tensors, their plain PyTorch version
(`bn_act_plain`, the op sequence `FrozenBatchNorm` then `+ residual` then
`F.relu`) for CPU tensors.

`bn_act(x, bn)` is relu(bn(x)); with `residual=r` relu(bn(x) + r); with
`down=(x_d, bn_d)` relu(bn(x) + bn_d(x_d)), the downsample branch's
affine computed in the same pass. x (and r, x_d) are NCHW tensors in
channels_last memory, bf16 or f32; `bn` is a `models.resnet.
FrozenBatchNorm`, whose four f32 buffers the kernel reads, computing
(inv, offset) per call as `FrozenBatchNorm.forward` does. The kernels give
the composition's bits: every product and sum rounded to the
activation's dtype where the composition rounds it. The backward reads
the saved output only, as `F.relu`'s does.

No Pallas kernel precedes them: the JAX package leaves BatchNorm, residual
and ReLU to XLA's fusion. `bn_act_forward` / `bn_act_backward` count
the two C entries' launches in `bn_act.launches` / `bn_act.bwd_launches`
by `shape_key` (`utils/trace.py`), under the spans `l2s.bn_act` /
`l2s.bn_act_bwd`. `launch_forward` / `launch_backward` launch without
counting, for tools that compare or time the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.trace import count, span
from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
_CL = torch.channels_last
_BUFFERS = ("weight", "bias", "running_mean", "running_var")
_NO_BN = (None, None, None, None, 0.0)
# a BatchNorm -> (its buffers, (C, device index), `_bn_args`' result)
_ARGS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("bn_act")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    bn = [p, p, p, p, f]
    lib.bn_act_fwd_launch.argtypes = [p] + bn + [p] + bn + [ll, i, i, i, p, p]
    lib.bn_act_fwd_launch.restype = i
    lib.bn_act_bwd_launch.argtypes = [p, p] + bn + bn + [ll, i, i, i, p, p,
                                                         p]
    lib.bn_act_bwd_launch.restype = i
    return lib


def bn_act_plain(x: torch.Tensor, bn, residual: Optional[torch.Tensor] = None,
                 down: Optional[Tuple[torch.Tensor, object]] = None
                 ) -> torch.Tensor:
    """relu(bn(x) [+ residual | + bn_d(x_d)]) as separate torch ops."""
    y = bn(x)
    if down is not None:
        residual = down[1](down[0])
    if residual is not None:
        y = y + residual
    return F.relu(y)


def _mode(other, bn_d) -> int:
    return 0 if other is None else (1 if bn_d is None else 2)


def shape_key(t: torch.Tensor, mode: int) -> Tuple:
    """The key a launch on the (N, C, H, W) map `t` in `mode` counts under
    (0 ReLU only, 1 residual, 2 downsample branch)."""
    return (*t.shape, mode, str(t.dtype).split(".")[-1])


def _check(t: torch.Tensor, what: str) -> Tuple[int, int]:
    """(pixels, C) of a channels_last NCHW activation (the C entries check
    C and the alignment)."""
    if not t.is_cuda or t.dtype not in _DTYPES or t.dim() != 4 \
            or not t.is_contiguous(memory_format=_CL):
        raise ValueError(f"bn_act: {what} must be a channels_last (N, C, H, "
                         f"W) float32 or bfloat16 CUDA tensor, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    n, c, h, w = t.shape
    return n * h * w, c


def _bn_args(bn, c: int, index: int) -> tuple:
    """The BatchNorm's four buffer pointers and eps. Its buffers are
    checked once for each set of buffer tensors, C and device, and the
    pointers kept: this runs on the host's hot path."""
    if bn is None:
        return _NO_BN
    bufs = [bn._buffers[k] for k in _BUFFERS]
    hit = _ARGS.get(bn)
    if hit is not None and hit[1] == (c, index) and all(
            a is b for a, b in zip(hit[0], bufs)):
        return hit[2]
    for t in bufs:
        if t.dtype is not torch.float32 or t.get_device() != index or \
                t.dim() != 1 or t.numel() != c or not t.is_contiguous():
            raise ValueError(f"bn_act: the BatchNorm's buffers must be "
                             f"contiguous float32 ({c},) on cuda:{index}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    args = (*[t.data_ptr() for t in bufs], bn.eps)
    _ARGS[bn] = (bufs, (c, index), args)
    return args


def _same(t: torch.Tensor, x: torch.Tensor, what: str) -> None:
    if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device \
            or not t.is_contiguous(memory_format=_CL):
        raise ValueError(f"bn_act: {what} must match x's {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}, channels_last; got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _launched(rc: int, what: str, t: torch.Tensor) -> None:
    """Raises on a C entry's nonzero cudaError_t for the map `t`."""
    if rc == 1:         # cudaErrorInvalidValue: the entry's own checks
        vec = 16 // t.element_size()
        raise ValueError(f"bn_act: the {what} kernel refused the launch: it "
                         f"needs C a multiple of {vec} and at most "
                         f"{512 * vec}, on 16-byte aligned maps; got C = "
                         f"{t.shape[1]}")
    if rc != 0:
        raise RuntimeError(f"bn_act {what} launch failed: cudaError {rc}")


def launch_forward(x: torch.Tensor, bn, other: Optional[torch.Tensor] = None,
                   bn_d=None) -> torch.Tensor:
    """One launch of the forward kernel, counted nowhere: relu(bn(x)),
    relu(bn(x) + other) (bn_d None) or relu(bn(x) + bn_d(other))."""
    pixels, c = _check(x, "x")
    if other is not None:
        _same(other, x, "the residual" if bn_d is None else "x_d")
    index = x.get_device()
    args = _bn_args(bn, c, index)
    args_d = _bn_args(bn_d, c, index)
    out = torch.empty_like(x, memory_format=_CL)
    stream = torch.cuda.current_stream(index).cuda_stream
    with torch.cuda.device(index):
        rc = _lib().bn_act_fwd_launch(
            x.data_ptr(), *args, None if other is None else other.data_ptr(),
            *args_d, pixels, c, int(x.dtype == torch.bfloat16),
            _mode(other, bn_d), out.data_ptr(), stream)
    _launched(rc, "forward", x)
    return out


def launch_backward(g: torch.Tensor, out: torch.Tensor, bn, bn_d=None,
                    mode: int = 0, need_x: bool = True, need_2: bool = True
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One launch of the backward kernel, counted nowhere: from the
    output's gradient g and the forward's output, (the gradient of x or
    None, of the residual (mode 1) / x_d (mode 2) or None)."""
    pixels, c = _check(out, "out")
    if not g.is_contiguous(memory_format=_CL) or g.data_ptr() % 16:
        g = g.clone(memory_format=_CL)
    _same(g, out, "the output's gradient")
    gx = torch.empty_like(out, memory_format=_CL) if need_x else None
    g2 = torch.empty_like(out, memory_format=_CL) if need_2 and mode \
        else None
    index = out.get_device()
    args = _bn_args(bn, c, index)
    args_d = _bn_args(bn_d if mode == 2 else None, c, index)
    stream = torch.cuda.current_stream(index).cuda_stream
    with torch.cuda.device(index):
        rc = _lib().bn_act_bwd_launch(
            g.data_ptr(), out.data_ptr(), *args, *args_d, pixels, c,
            int(out.dtype == torch.bfloat16), mode,
            None if gx is None else gx.data_ptr(),
            None if g2 is None else g2.data_ptr(), stream)
    _launched(rc, "backward", out)
    return gx, g2


@span("l2s.bn_act")
def bn_act_forward(x, bn, other=None, bn_d=None):
    """`launch_forward`, counted in `bn_act.launches`."""
    out = launch_forward(x, bn, other, bn_d)
    count("bn_act.launches", key=shape_key(x, _mode(other, bn_d)))
    return out


@span("l2s.bn_act_bwd")
def bn_act_backward(g, out, bn, bn_d, mode, need_x, need_2):
    """`launch_backward`, counted in `bn_act.bwd_launches`."""
    grads = launch_backward(g, out, bn, bn_d, mode, need_x, need_2)
    count("bn_act.bwd_launches", key=shape_key(out, mode))
    return grads


class _BnAct(torch.autograd.Function):
    """The kernels under autograd; saves the output only."""

    @staticmethod
    def forward(ctx, x, other, bn, bn_d):
        out = bn_act_forward(x, bn, other, bn_d)
        ctx.save_for_backward(out)
        ctx.bns = (bn, bn_d)
        ctx.mode = _mode(other, bn_d)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        need_x, need_2 = ctx.needs_input_grad[:2]
        gx, g2 = bn_act_backward(g, out, *ctx.bns, ctx.mode, need_x, need_2)
        return gx, g2, None, None


def bn_act(x: torch.Tensor, bn, residual: Optional[torch.Tensor] = None,
           down: Optional[Tuple[torch.Tensor, object]] = None
           ) -> torch.Tensor:
    """relu(bn(x)), relu(bn(x) + residual) or, with down = (x_d, bn_d),
    relu(bn(x) + bn_d(x_d)): the kernel for CUDA tensors (under autograd
    where an input needs a gradient), `bn_act_plain` for CPU tensors."""
    if not x.is_cuda:
        return bn_act_plain(x, bn, residual, down)
    other, bn_d = (residual, None) if down is None else down
    if torch.is_grad_enabled() and (
            x.requires_grad or (other is not None and other.requires_grad)):
        return _BnAct.apply(x, other, bn, bn_d)
    return bn_act_forward(x, bn, other, bn_d)
