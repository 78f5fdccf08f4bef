"""CUDA kernels of the PyTorch port against their plain versions, on the
card. These tests need an NVIDIA GPU with nvcc (the kernels have no
CPU mode) and skip without one; they import nothing of JAX, so they run
on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

`chip_smoke.py` runs the same comparisons at the flagship shapes."""

import numpy as np
import pytest
import torch

from lang2seg_tpu_torch.ops import fused_filter, nms_cuda
from lang2seg_tpu_torch.ops.fused_filter import fused_dynamic_filter_plain
from lang2seg_tpu_torch.ops.nms import nms_padded

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _boxes(rng, e, n, lim=100.0):
    xy = rng.uniform(0, lim, (e, n, 2))
    wh = rng.uniform(5, lim / 2, (e, n, 2))
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                            .astype(np.float32))


@pytest.mark.parametrize("e,n,thresh,max_out", [(3, 700, 0.7, 128),
                                                 (2, 64, 0.5, 64),
                                                 (1, 1, 0.7, 4),
                                                 (4, 2000, 0.99, 300)])
def test_nms_kernel_bit_identical(dev, e, n, thresh, max_out):
    rng = np.random.RandomState(n)
    boxes = _boxes(rng, e, n).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(e, n)) > 0.1).to(dev)
    before = nms_cuda.launches
    ki, km = nms_cuda.nms_batched(boxes, valid, thresh, max_out)
    assert nms_cuda.launches == before + 1
    pi, pm = nms_padded(boxes, valid, thresh, max_out)
    assert torch.equal(ki, pi) and torch.equal(km, pm)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,gate,normalize", [(7, "sigmoid", True),
                                              (1, "multiply", False)])
def test_gate_kernel_matches_plain(dev, dtype, k, gate, normalize):
    g = torch.Generator().manual_seed(k)
    e, h, w, c = 3, 9, 20, 512
    conv = torch.randn((1, h, w, c), generator=g).to(dev, dtype)
    conv = conv.expand(e, h, w, c)
    filt = (torch.tanh(torch.randn((e, c, k), generator=g))
            * (1.0 if normalize else 0.05)).to(dev)
    rfilt = torch.tanh(torch.randn((e, k), generator=g)).to(dev)
    before = fused_filter.launches
    gk, rk = fused_filter.fused_dynamic_filter(conv, filt, rfilt, k, gate,
                                               normalize)
    assert fused_filter.launches == before + 1
    gp, rp = fused_dynamic_filter_plain(conv, filt, rfilt, k, gate, normalize)
    # f32 sums in another order: 1e-3 of the response's range; given the
    # kernel's response, the gated map is one rounding of conv * g, so it
    # may move by one ulp of dtype (f32: two, one more for the kernel's own
    # sigmoid)
    assert float((rk - rp).abs().max()) <= 1e-3 * float(rp.abs().max())
    g_k = torch.sigmoid(rk) if gate == "sigmoid" else rk
    want = (conv.float() * g_k).to(dtype).float()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    tol = ulp * want.abs() + 1e-30
    assert bool(((gk.float() - want).abs() <= tol).all())
