"""The ROI crop (POOLING_MODE 'crop') of the port against the JAX package,
at small sizes on the CPU: `crop_and_resize` / `roi_crop_pool` against
JAX's `crop_and_resize` (the einsum pair) and `crop_and_resize_gather`
(its 4-tap oracle) under `jax.vmap`; the plain backward
(`crop_and_resize_bwd_plain`, the backward kernel's fixed-order
algorithm) against `jax.vjp` of JAX's `roi_crop_pool` and torch autograd
of the einsum pair; `crop_gather_plain` (the forward kernel's algorithm)
against the einsum pair; the model's `_roi_features` and its gradient
against JAX's. ROIs: proposals and the edge ROIs of
`tools/profile_crop.py::edge_rois` (off the map, partly off, zero width
or height, samples on integral coordinates, the whole map, far wider
than the map, inside one cell). The kernels themselves run in
tests/test_torch_cuda.py on the card.

Tolerances, each with its reason:
* f32: 1e-5 of the largest magnitude. Each output sums two products a
  pass; JAX's and torch's CPU products fuse them into FMAs or not (a few
  f32 ulps); the backward sums hundreds of products in another order.
* bf16 forward against JAX's einsum pair: bit for bit: both round a
  two-term f32 sum of exact products to bf16 twice.
* bf16 against JAX's gather oracle: 6 bf16 ulps at the scale of the crop
  of |map| (`profile_crop.ulps_at`): the oracle rounds 11 times in bf16
  (each tap's weight wy * wx and its product with the map, then three
  sums), the einsum pair twice (the x pass, the output), each rounding
  within half an ulp at that scale.
* bf16 backward against `jax.vjp`: 3 bf16 ulps at the scale of the same
  backward of |grad|: XLA sums the (R, H, S) intermediate and the map's
  gradient in another order (one rounding of the result, and one for
  each of up to two intermediates that round the other way)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lang2seg_tpu.ops.roi_align import crop_and_resize_gather as jgather
from lang2seg_tpu.ops.roi_align import roi_crop_pool as jroi_crop_pool
from lang2seg_tpu_torch.ops import roi_crop_cuda
from lang2seg_tpu_torch.ops.roi_align import (_sample_coords,
                                              crop_and_resize,
                                              crop_and_resize_bwd_plain,
                                              crop_and_resize_plain,
                                              crop_bwd_coords_plain,
                                              crop_gather_plain,
                                              roi_crop_pool)
from lang2seg_tpu_torch.tools.profile_crop import (crop_bound,
                                                   crop_bwd_bound,
                                                   crop_inputs, edge_rois,
                                                   tap_pixels, ulps_at)
from lang2seg_tpu_torch.utils import trace
from tests.test_torch_weights import response_config, shared_weights

SCALE = 1.0 / 16
H, W = 20, 30
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
F32_REL = 1e-5
GATHER_ULPS = 6.0
BWD_ULPS = 3.0


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(dtype, maps="gathered", e=3, r=24, c=16, seed=0, s=7):
    return crop_inputs(e, r, H, W, c, maps, "cpu", dtype, seed=seed, s=s)


def _to_jax(t, jdtype):
    return jnp.asarray(t.float().numpy()).astype(jdtype)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _coords(rois, s=7):
    ys, xs = _sample_coords(rois, s, SCALE)
    return ys.contiguous(), xs.contiguous()


def _assert_f32_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= F32_REL * np.abs(want).max()


def test_edge_rois_reach_every_case():
    """The edge ROIs hold samples off the map, on integral coordinates and
    a zero-extent side: each case the kernels special-case is drawn."""
    ys, xs = _coords(edge_rois(H, W)[None], 7)
    assert bool(((ys < -1) | (ys > H)).any() & ((xs < -1) | (xs > W)).any())
    assert bool((ys == ys.floor()).all(-1).any())          # integral rows
    assert bool((xs[0, 3] == xs[0, 3, 0]).all())           # zero width
    assert bool((ys[0, 4] == ys[0, 4, 0]).all())           # zero height


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("maps", ["gathered", "broadcast"])
@pytest.mark.parametrize("max_pool", [False, True])
def test_crop_matches_jax(dtype, maps, max_pool):
    """`roi_crop_pool` on the CPU (the einsum pair) against JAX's einsum
    pair: f32 within 1e-5, bf16 bit for bit; a stride-0 map reads as its
    materialised copy."""
    tdt, jdt = DTYPES[dtype]
    feat, rois, _ = _inputs(tdt, maps)
    got = roi_crop_pool(feat, rois, 7, SCALE, max_pool)
    want = jax.vmap(lambda f, r: jroi_crop_pool(f, r, 7, SCALE, max_pool))(
        _to_jax(feat, jdt), jnp.asarray(rois.numpy()))
    if tdt == torch.bfloat16:
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    else:
        _assert_f32_close(got.numpy(), _np(want))
    assert torch.equal(got, roi_crop_pool(feat.contiguous(), rois, 7, SCALE,
                                          max_pool))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_crop_matches_jax_gather_oracle(dtype):
    """`crop_and_resize` and `crop_gather_plain` against JAX's 4-tap
    gather: f32 within 1e-5, bf16 within 6 ulps at the scale of the crop
    of |map|."""
    tdt, jdt = DTYPES[dtype]
    feat, rois, _ = _inputs(tdt)
    want = jax.vmap(lambda f, r: jgather(f, r, 7, SCALE))(
        _to_jax(feat, jdt), jnp.asarray(rois.numpy()))
    ys, xs = _coords(rois)
    mag = crop_and_resize_plain(feat.abs(), ys, xs)
    for got in (crop_and_resize(feat, rois, 7, SCALE),
                crop_gather_plain(feat, ys, xs)):
        if tdt == torch.bfloat16:
            w = torch.tensor(_np(want)).to(torch.bfloat16)
            assert float(ulps_at(got, w, mag).max()) <= GATHER_ULPS
        else:
            _assert_f32_close(got.numpy(), _np(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", [7, 14])
def test_gather_plain_equals_einsum_pair(dtype, s):
    """The forward kernel's algorithm in torch ops against the einsum
    pair on the CPU: bf16 bit for bit (each pass one rounding of a two-term
    f32 sum of exact products); f32 within 1e-5 (the CPU's matrix product
    fuses the second product into an FMA)."""
    tdt, _ = DTYPES[dtype]
    feat, rois, _ = _inputs(tdt, s=s)
    ys, xs = _coords(rois, s)
    got = crop_gather_plain(feat, ys, xs)
    want = crop_and_resize_plain(feat, ys, xs)
    if tdt == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        _assert_f32_close(got.numpy(), want.numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("max_pool", [False, True])
def test_backward_matches_jax_vjp(dtype, max_pool):
    """The gradient of `roi_crop_pool` with respect to the map on the CPU
    (the `RoICrop` node: `crop_bwd_coords_plain`, then the max pool's)
    against `jax.vjp` of JAX's `roi_crop_pool`: f32 within 1e-5, bf16
    within 3 ulps at the scale of the same backward of |grad|."""
    tdt, jdt = DTYPES[dtype]
    feat, rois, _ = _inputs(tdt)
    leaf = feat.detach().clone().requires_grad_(True)
    out = roi_crop_pool(leaf, rois, 7, SCALE, max_pool)
    g = torch.from_numpy(np.random.RandomState(1).randn(
        *out.shape).astype(np.float32)).to(tdt)
    got, = torch.autograd.grad(out, leaf, g)
    _, vjp = jax.vjp(lambda f: jax.vmap(
        lambda a, b: jroi_crop_pool(a, b, 7, SCALE, max_pool))(
            f, jnp.asarray(rois.numpy())), _to_jax(feat, jdt))
    want, = vjp(_to_jax(g, jdt))
    if tdt == torch.bfloat16:
        abs_leaf = feat.abs().requires_grad_(True)
        mag, = torch.autograd.grad(roi_crop_pool(
            abs_leaf, rois, 7, SCALE, max_pool), abs_leaf, g.abs())
        w = torch.tensor(_np(want)).to(torch.bfloat16)
        assert float(ulps_at(got, w, mag).max()) <= BWD_ULPS
    else:
        _assert_f32_close(got.numpy(), _np(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("maps", ["gathered", "broadcast"])
def test_backward_plain_matches_autograd_of_einsum_pair(dtype, maps):
    """`crop_and_resize_bwd_plain` against torch autograd of the einsum
    pair on the CPU: bf16 bit for bit here (the CPU's products sum the
    few terms of each element in the same order), f32 within 1e-5."""
    tdt, _ = DTYPES[dtype]
    feat, rois, grad = _inputs(tdt, maps)
    got = crop_and_resize_bwd_plain(feat, rois, grad, 7, SCALE)
    leaf = feat.detach().clone().requires_grad_(True)
    ys, xs = _coords(rois)
    want, = torch.autograd.grad(crop_and_resize_plain(leaf, ys, xs), leaf,
                                grad)
    assert got.shape == feat.shape and got.dtype == tdt
    if tdt == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        _assert_f32_close(got.numpy(), want.numpy())
    assert torch.equal(got, crop_bwd_coords_plain(grad, ys, xs, H, W))


def test_cpu_crop_never_touches_the_library(monkeypatch):
    """On CPU tensors the crop, its autograd node and the model's ROI
    features take the plain versions: the library is never loaded and the
    launch counters, in total and by shape, do not move."""
    def refuse():
        raise AssertionError("the CPU path loaded the CUDA library")
    monkeypatch.setattr(roi_crop_cuda, "_lib", refuse)
    names = ("roi_crop.launches", "roi_crop.bwd_launches")

    def counts():
        c = trace.counters()
        return [(c.get(n, 0), trace.by_key(n)) for n in names]
    before = counts()
    feat, rois, _ = _inputs(torch.float32)
    with torch.no_grad():
        crop_and_resize(feat, rois, 7, SCALE)
    leaf = feat.clone().requires_grad_(True)
    roi_crop_pool(leaf, rois, 7, SCALE, True).square().sum().backward()
    assert leaf.grad is not None and bool(leaf.grad.abs().sum() > 0)
    assert counts() == before


def test_crop_refuses_rois_with_a_gradient_and_other_devices():
    feat, rois, _ = _inputs(torch.float32)
    with pytest.raises(ValueError, match="ROIs carry no gradient"):
        crop_and_resize(feat, rois.requires_grad_(True), 7, SCALE)
    with torch.no_grad():                 # no gradient wanted: no node
        crop_and_resize(feat, rois, 7, SCALE)
    with pytest.raises(ValueError, match="device"):
        crop_and_resize(torch.zeros((1, 4, 4, 8), device="meta"),
                        torch.zeros((1, 1, 4), device="meta"), 7, SCALE)


def test_roi_features_and_gradient_match_jax(rng):
    """The slice: the model's `_roi_features` (crop -> layer4 tail) and
    its gradient with respect to the gated map, against JAX's through
    `jax.vjp`, at the tiny f32 config (the tail's convolutions sum in
    another order: 1e-3, as tests/test_torch_models.py)."""
    cfg = response_config()
    model, jmodel, params = shared_weights(cfg, seed=1)
    gated = (rng.randn(2, 8, 12, 1024) * 0.5).astype(np.float32)
    boxes = np.asarray([[[16.0, 8.0, 100.0, 90.0], [-40.0, -8.0, 40.0, 30.0],
                         [0.0, 0.0, 176.0, 112.0]],
                        [[40.0, 30.0, 180.0, 120.0], [5.0, 60.0, 5.0, 120.0],
                         [150.0, 100.0, 400.0, 300.0]]], np.float32)
    g = (rng.randn(2, 3, 7, 7, 2048) * 0.1).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want, vjp = jax.vjp(lambda x: jmodel.apply(
            {"params": params}, x, jnp.asarray(boxes),
            method=lambda m, a, b: m._roi_features(a, b)), jnp.asarray(gated))
        want_d, = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(gated).requires_grad_(True)
    got = model._roi_features(leaf, torch.from_numpy(boxes))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_d),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,w,s", [(40, 64, 7), (40, 64, 14), (8, 12, 7),
                                   (120, 128, 7)])
def test_band_plan_fits_shared_memory(dtype, h, w, s):
    """The backward's plan for 16 expressions: a CTA of one warp for each
    4 pixels of a row (the 40 x 64 map of every full-width path in 40 x 16
    warps), or for each pixel where that would give fewer than 32 warps
    on each of 132 SMs, and a 16-byte vector of channels a lane (256
    bf16 or 128 f32 a slab), its sums in registers: no shared memory, so
    32 such CTAs share an SM of an H100 whatever the map, the samples or
    the ROIs."""
    tdt, _ = DTYPES[dtype]
    plan = roi_crop_cuda.band_plan(h, w, 1024, tdt, s, 16)
    elem = 2 if tdt == torch.bfloat16 else 4
    assert plan["channels"] * elem == 32 * 16
    assert plan["slabs"] * plan["channels"] == 1024
    wide = h * -(-w // 4) * plan["slabs"] * 16 >= 132 * 32
    assert plan["pixels"] == (4 if wide else 1)
    assert plan["segments"] * plan["pixels"] >= w > \
        (plan["segments"] - 1) * plan["pixels"]
    assert plan["ctas"] == h * plan["segments"]
    assert (h, w) != (40, 64) or plan["ctas"] == 640
    assert (h, w) != (8, 12) or plan["pixels"] == 1
    assert plan["threads"] == 32 and plan["smem"] == 0


@pytest.mark.parametrize("h,w,c", [(1, 3, 8), (3, 17, 24), (40, 64, 512),
                                   (41, 65, 1032)])
def test_band_plan_tiles_cover_the_map(h, w, c):
    """The warps and slabs of the plan cover every pixel and channel of a
    map once, whatever its size (a row narrower than a warp's 4 pixels, a
    partial slab of channels)."""
    for tdt in (torch.bfloat16, torch.float32):
        plan = roi_crop_cuda.band_plan(h, w, c, tdt, 7)
        cols = [min(plan["pixels"], w - k * plan["pixels"])
                for k in range(plan["segments"])]
        chans = [min(plan["channels"], c - k * plan["channels"])
                 for k in range(plan["slabs"])]
        assert min(cols + chans) > 0
        assert (sum(cols), sum(chans)) == (w, c)
        assert plan["ctas"] * plan["pixels"] >= h * w


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,w,s", [(40, 64, 7), (40, 64, 14), (8, 12, 7),
                                   (120, 128, 7)])
def test_baseline_band_plan_fits_its_shared_memory(dtype, h, w, s):
    """The plan `profile_crop --baseline` gives the earlier source's
    backward: a 32-byte channel slab of rows of w + 1 pixels in f32, at
    most 1024 threads (a row, channel pair and third of the columns each),
    1 to 32 ROIs' gradient staged beside it, within 227 KiB less its
    8.5 KiB of static shared memory."""
    from lang2seg_tpu_torch.tools.profile_crop import baseline_band_plan
    tdt, _ = DTYPES[dtype]
    elem = 2 if tdt == torch.bfloat16 else 4
    band_rows, chunk = baseline_band_plan(h, w, 1024, tdt, s)
    assert 1 <= band_rows <= h and band_rows * 32 // elem // 2 * 3 <= 1024
    assert (h, w) != (40, 64) or band_rows == 40
    assert 1 <= chunk <= 32
    assert band_rows * (w + 1) * 32 * 4 // elem + chunk * s * s * 32 + \
        8704 <= 227 * 1024


def test_roi_reach_counts_rows_with_a_weight():
    """`profile_crop.roi_reach` (what `profile_train.py` prints of a step's
    crop) against a brute force over every map row and sample on the edge
    ROIs and proposals: the rows under a y tap whose weight is not zero
    (at most 2 S, whatever the ROI's height), and the ROIs' extents in
    cells."""
    from lang2seg_tpu_torch.tools.profile_crop import roi_reach
    rois = torch.cat([edge_rois(H, W)[None], _inputs(torch.float32, e=1,
                                                     r=10)[1]], 1)
    ys, xs = _coords(rois)
    got = roi_reach(ys, xs, H)
    rows = [sum(any(max(0.0, 1.0 - abs(float(v) - y)) > 0 for v in ys[0, q])
                for y in range(H)) for q in range(ys.shape[1])]
    heights = (ys[0, :, -1] - ys[0, :, 0]).abs()
    widths = (xs[0, :, -1] - xs[0, :, 0]).abs()
    assert got["rows_max"] == max(rows)
    assert got["rows_mean"] == pytest.approx(np.mean(rows))
    # off the map: no row; a ROI reaches at most two rows a sample row
    assert 0 in rows and max(rows) <= 2 * ys.shape[2]
    assert got["height_max"] == float(heights.max())
    assert got["width_mean"] == pytest.approx(float(widths.mean()))


def test_crop_bound_counts_tapped_pixels_once():
    """The forward's byte bound reads each map pixel under some tap once
    (a ROI reads its taps' rows by their columns), a stride-0 map's union
    once, and writes the crops; the backward reads the crops' gradient
    and writes the maps' gradient in full."""
    rois = torch.tensor([[[0.0, 0.0, 48.0, 32.0],      # rows 0-2, cols 0-3
                          [16.0, 16.0, 64.0, 48.0]],   # rows 1-3, cols 1-4
                         [[-300.0, -200.0, -40.0, -24.0],   # off the map
                          [16.0, 16.0, 16.0, 16.0]]])  # cell (1, 1) alone
    assert tap_pixels(rois, H, W, "gathered", 7) == 3 * 4 + 3 * 4 - 2 * 3 + 1
    assert tap_pixels(rois, H, W, "broadcast", 7) == 3 * 4 + 3 * 4 - 2 * 3
    _, by, byts, ops = crop_bound(rois, H, W, 8, 2, "gathered", 7)
    out = 2 * 2 * 7 * 7 * 8
    assert by == "bytes"
    assert byts == 19 * 8 * 2 + 2 * 2 * 16 + out * 2 and ops == out * 12
    _, _, bwd_bytes, _ = crop_bwd_bound(rois, H, W, 8, 2, 7)
    assert bwd_bytes == out * 2 + 2 * 2 * 16 + 2 * H * W * 8 * 2


def test_roi_tail_in_pieces_past_its_limit(monkeypatch, rng):
    """Outside training, more crops than `TAIL_CROPS` run the tail on
    pieces of `TAIL_PIECE` crops (test mode 'top' at 16 expressions): the
    same features as one call, within 1e-6 of their largest magnitude
    (the CPU's convolutions may tile a smaller batch otherwise); with a
    gradient the tail is one call."""
    from lang2seg_tpu_torch.models import network
    cfg = response_config()
    model, _, _ = shared_weights(cfg, seed=1)
    gated = torch.from_numpy((rng.randn(2, 8, 12, 1024) * 0.5).astype(
        np.float32))
    boxes = torch.from_numpy(np.stack([
        np.concatenate([xy, xy + wh], 1) for xy, wh in zip(
            rng.uniform(0, 120, (2, 5, 2)), rng.uniform(8, 70, (2, 5, 2)))
    ]).astype(np.float32))
    with torch.no_grad():
        whole = model._roi_features(gated, boxes)
    calls = []
    tail = model.resnet.tail
    monkeypatch.setattr(model.resnet, "tail",
                        lambda x: calls.append(x.shape[0]) or tail(x))
    monkeypatch.setattr(network, "TAIL_CROPS", 6)
    monkeypatch.setattr(network, "TAIL_PIECE", 4)
    with torch.no_grad():
        pieces = model._roi_features(gated, boxes)
    assert calls == [4, 4, 2]
    assert pieces.shape == whole.shape
    assert float((pieces - whole).abs().max()) <= \
        1e-6 * float(whole.abs().max())
    calls.clear()
    model._roi_features(gated.requires_grad_(True), boxes)
    assert calls == [10]
