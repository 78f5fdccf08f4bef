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
from lang2seg_tpu_torch.ops.fused_filter import (
    fused_dynamic_filter_bwd_plain, fused_dynamic_filter_plain)
from lang2seg_tpu_torch.ops.nms import nms_padded
from lang2seg_tpu_torch.tools.profile_nms import edge_cases

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


# the small edge cases of chip_smoke.py phase 3, by name
EDGE = {c[0]: c[1:] for c in edge_cases() if c[1].shape[1] <= 500}
RANDOM = [(3, 700, 0.7, 128), (2, 64, 0.5, 64), (1, 1, 0.7, 4),
          (4, 2000, 0.99, 300)]


def _nms_case(case, dev):
    """(boxes, valid, thresh, max_out) on the card: a random draw for
    (e, n, thresh, max_out), or the edge case of that name."""
    if isinstance(case, str):
        b, v, thresh, max_out = EDGE[case]
        return (torch.from_numpy(b).to(dev), torch.from_numpy(v).to(dev),
                thresh, max_out)
    e, n, thresh, max_out = case
    rng = np.random.RandomState(n)
    boxes = _boxes(rng, e, n).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(e, n)) > 0.1).to(dev)
    return boxes, valid, thresh, max_out


@pytest.mark.parametrize("case", [pytest.param(c, id="-".join(map(str, c)))
                                  for c in RANDOM] + list(EDGE))
def test_nms_kernel_bit_identical(dev, case):
    """Random draws, and the edge cases: tile edges, max_out at a tile's
    end, mid-tile and above N, an all-invalid lane, 1, 4 and 8 lanes."""
    boxes, valid, thresh, max_out = _nms_case(case, dev)
    before = nms_cuda.launches
    ki, km = nms_cuda.nms_batched(boxes, valid, thresh, max_out)
    assert nms_cuda.launches == before + 1
    pi, pm = nms_padded(boxes, valid, thresh, max_out)
    assert torch.equal(ki, pi) and torch.equal(km, pm)


@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("case", [
    pytest.param((3, 700, 0.7, 128), id="3-700-0.7-128"),
    "invalid_lane_3x300_128", "max_out_mid_tile_2x200_100"])
def test_nms_kernel_any_cluster_size(dev, case, cluster):
    """Every cluster size (CTAs per lane) gives the same bits."""
    boxes, valid, thresh, max_out = _nms_case(case, dev)
    ki, km = nms_cuda._launch(boxes, valid, thresh, max_out, cluster)
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


def bf16_ulps_floored(got, want):
    """bf16 ulp distance, counted in ulps of max(|want|, 2^-8 max|want|).
    d_conv = d_gated * g + scale * (d_resp0 . filt) is rounded once to
    bf16 in both versions, but d_g inside d_resp0 is a sum over C in
    another order: where the two terms cancel, that f32 difference is
    many ulps of the small result, never of the 2^-8 floor."""
    want = want.float()
    mag = torch.maximum(want.abs(), want.abs().max() * 2.0 ** -8)
    ulp = 2.0 ** (torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want).abs() / ulp).max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,gate,normalize", [(7, "sigmoid", True),
                                              (1, "multiply", False),
                                              (7, "multiply", False)])
@pytest.mark.parametrize("c", [256, 1024])
def test_gate_bwd_kernel_matches_plain(dev, dtype, k, gate, normalize, c):
    """The backward kernel against its plain version, on a map gathered
    from 2 images (as in training) and on a stride-0 broadcast map."""
    g = torch.Generator().manual_seed(c + k)
    e, h, w = 5, 9, 20
    img = torch.randn((2, h, w, c), generator=g).to(dev, dtype)
    idx = torch.tensor([0, 1, 1, 0, 1], device=dev)
    filt = (torch.tanh(torch.randn((e, c, k), generator=g))
            * (1.0 if normalize else 0.05)).to(dev)
    rfilt = (torch.tanh(torch.randn((e, k), generator=g)) if k == 7
             else torch.ones((e, 1))).to(dev)
    d_gated = torch.randn((e, h, w, c), generator=g).to(dev, dtype)
    d_resp = torch.randn((e, h, w, 1), generator=g).to(dev)
    for conv in (img[idx], img[:1].expand(e, h, w, c)):
        _, fused = fused_dynamic_filter_plain(conv, filt, rfilt, k, gate,
                                              normalize)
        before = fused_filter.bwd_launches
        got = fused_filter.fused_dynamic_filter_bwd(
            conv, filt, rfilt, fused, d_gated, d_resp, k, gate, normalize)
        assert fused_filter.bwd_launches == before + 1
        want = fused_dynamic_filter_bwd_plain(
            conv, filt, rfilt, fused, d_gated, d_resp, k, gate, normalize)
        torch.cuda.synchronize()
        # d_conv: one rounding of an f32 value whose sums ran in another
        # order: 2 ulps of the map's dtype (f32: relative 1e-5)
        if dtype == torch.bfloat16:
            assert float(bf16_ulps_floored(got[0], want[0])) <= 2.0
        else:
            assert float((got[0] - want[0]).abs().max()) <= \
                1e-5 * float(want[0].abs().max())
        # d_filt, d_rfilt: f32 sums over the pixels in another order
        for a, b in zip(got[1:], want[1:]):
            assert float((a - b).abs().max()) <= \
                1e-3 * max(float(b.abs().max()), 1e-30)
        again = fused_filter.fused_dynamic_filter_bwd(
            conv, filt, rfilt, fused, d_gated, d_resp, k, gate, normalize)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_gate_autograd_launches_both_kernels(dev):
    g = torch.Generator().manual_seed(0)
    e, h, w, c = 3, 8, 16, 512
    conv = torch.randn((e, h, w, c), generator=g).to(dev, torch.bfloat16)
    conv.requires_grad_(True)
    filt = torch.tanh(torch.randn((e, c, 7), generator=g)).to(dev)
    rfilt = torch.tanh(torch.randn((e, 7), generator=g)).to(dev)
    filt.requires_grad_(True)
    rfilt.requires_grad_(True)
    f0, b0 = fused_filter.launches, fused_filter.bwd_launches
    gated, resp = fused_filter.fused_dynamic_filter(conv, filt, rfilt, 7,
                                                    "sigmoid", True)
    (gated.float().square().sum() + resp.sum()).backward()
    assert (fused_filter.launches - f0, fused_filter.bwd_launches - b0) \
        == (1, 1)
    for t in (conv, filt, rfilt):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
