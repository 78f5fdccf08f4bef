"""ROI max pooling (POOLING_MODE 'pool') of the port against the JAX
package's `roi_max_pool` under `jax.vmap`, run eagerly, on small maps:
proposals with the edge ROIs of `tools/profile_roi_pool.py` (off the
map, 1 x 1, empty bins, corners on .5 after scaling, windows of ties) on
maps quantized to multiples of 1/4, gathered from 2 images or broadcast
from one.

* the forward is bit-identical in f32 and bf16, and so are the bins;
* the gradient of sum(out^2) against jax.grad: exact in f32, within 1
  bf16 ulp in bf16 (a pixel that is the maximum of several bins sums
  their gradients; XLA's scatter and torch's accumulate in the same
  order here);
* the plain version over chunks of ROIs equals it in one piece;
* the JAX fault the port does not copy: jitted, XLA turns the bin width
  rw / 7 into a product with 1/7, so that ceil(7 * bw) can overshoot by a
  cell; eager JAX, the reference's NumPy oracle and the port keep the true
  quotient."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lang2seg_tpu.ops.roi_align import _roi_pool_bins
from lang2seg_tpu.ops.roi_align import roi_max_pool as jroi_max_pool
from lang2seg_tpu_torch.ops import roi_pool_cuda
from lang2seg_tpu_torch.ops.roi_align import (roi_max_pool,
                                              roi_max_pool_argmax_plain,
                                              roi_max_pool_bwd_plain,
                                              roi_max_pool_plain,
                                              roi_pool_bins)
from lang2seg_tpu_torch.tools.profile_gate import bf16_ulp_distance
from lang2seg_tpu_torch.tools.profile_roi_pool import (edge_rois,
                                                       map_pixels,
                                                       oversize_bins,
                                                       roi_pool_bound,
                                                       roi_pool_inputs)
from tests.test_roi_align import roi_pool_oracle

P, SCALE = 7, 1.0 / 16
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_pool(feat, rois):
    return jax.vmap(lambda f, r: jroi_max_pool(f, r, P, SCALE))(feat, rois)


def _inputs(dtype, maps="gathered", e=3, r=40, c=16, seed=0):
    feat, rois, _ = roi_pool_inputs(e, r, 20, 30, c, maps, "cpu", dtype,
                                    seed=seed)
    return feat, rois


def _to_jax(t, jdtype):
    return jnp.asarray(t.float().numpy()).astype(jdtype)


def test_roi_pool_bins_match_jax():
    """Every bin edge of 2000 ROIs (proposals, the edge ROIs, corners on
    .5 after scaling, extents 1 to 80 cells) against JAX's
    `_roi_pool_bins`, as integers."""
    rng = np.random.RandomState(0)
    xy = rng.randint(-40, 120, (2000, 2)) * 8.0          # many on .5
    wh = rng.randint(0, 80, (2000, 2)) * 8.0
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    rois[:12] = edge_rois(20, 30).numpy()
    got = roi_pool_bins(torch.from_numpy(rois), P, SCALE, 20, 30)
    want = _roi_pool_bins(jnp.asarray(rois), P, SCALE, 20, 30)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("maps", ["gathered", "broadcast"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_roi_max_pool_forward_matches_jax(dtype, maps):
    """The forward bit for bit against JAX (eager), and against the
    reference's NumPy oracle (tests/test_roi_align.py) in f32; the edge
    ROIs give empty bins (0) and windows of ties."""
    tdt, jdt = DTYPES[dtype]
    feat, rois = _inputs(tdt, maps)
    got = roi_max_pool(feat, rois, P, SCALE)
    want = _jax_pool(_to_jax(feat, jdt), jnp.asarray(rois.numpy()))
    assert got.dtype == tdt and got.shape == (3, 40, P, P, 16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert bool((roi_max_pool_argmax_plain(feat, rois, P, SCALE) < 0).any())
    if dtype == "float32":
        for i in range(3):
            oracle = roi_pool_oracle(feat[i].numpy(), rois[i].numpy(), P,
                                     SCALE)
            np.testing.assert_array_equal(got[i].numpy(), oracle)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_roi_max_pool_gradient_matches_jax(dtype):
    """The gradient of sum(out^2) (each output's gradient to its bin's
    first maximum in row-major order, ties included, f32 sums cast once)
    against jax.grad of JAX's custom VJP: exact in f32, within 1 bf16 ulp
    in bf16."""
    tdt, jdt = DTYPES[dtype]
    feat, rois = _inputs(tdt, seed=1)
    feat.requires_grad_(True)
    roi_max_pool(feat, rois, P, SCALE).float().square().sum().backward()
    jrois = jnp.asarray(rois.numpy())
    want = jax.grad(lambda f: jnp.sum(jnp.square(
        _jax_pool(f, jrois).astype(jnp.float32))))(_to_jax(feat.detach(),
                                                            jdt))
    assert feat.grad.dtype == tdt
    if dtype == "float32":
        np.testing.assert_array_equal(feat.grad.numpy(), np.asarray(want))
    else:
        want = torch.from_numpy(np.array(want.astype(jnp.float32)))
        assert int(bf16_ulp_distance(feat.grad, want).max()) <= 1
    assert float(feat.grad.abs().sum()) > 0


@pytest.mark.parametrize("part", ["forward", "argmax", "backward"])
def test_roi_max_pool_chunked_equals_whole(part):
    """The plain version over chunks of one ROI (the intermediates cut to
    a few KB) equals it in one piece, bit for bit."""
    feat, rois, grad = roi_pool_inputs(2, 24, 20, 30, 8, "gathered", "cpu",
                                       torch.bfloat16, seed=2)
    fn = {"forward": lambda **k: roi_max_pool_plain(feat, rois, P, SCALE,
                                                    **k),
          "argmax": lambda **k: roi_max_pool_argmax_plain(feat, rois, P,
                                                          SCALE, **k),
          "backward": lambda **k: roi_max_pool_bwd_plain(feat, rois, grad,
                                                         P, SCALE, **k)}[part]
    assert torch.equal(fn(chunk_bytes=1), fn(chunk_bytes=1 << 40))


def test_jax_jit_moves_roi_pool_bin_edges():
    """A ROI 3 cells high (rows 0-2): its last bin is rows [floor(6 * 3 /
    7), ceil(7 * 3 / 7)) = [2, 3). Jitted on the CPU, XLA computes 3 / 7
    as 3 * (1 / 7) = 0.42857146, and 7 times that is 3.0000002, whose
    ceil takes row 3 in: the bin's maximum is read outside the ROI. Eager
    JAX, the reference's NumPy oracle and the port keep row 3 out."""
    feat = np.zeros((1, 8, 8, 1), np.float32)
    feat[0, 3, :, 0] = 5.0
    rois = np.array([[[0.0, 0.0, 32.0, 32.0]]], np.float32)    # cells 0-2
    eager = np.asarray(_jax_pool(jnp.asarray(feat), jnp.asarray(rois)))
    jitted = np.asarray(jax.jit(_jax_pool)(jnp.asarray(feat),
                                           jnp.asarray(rois)))
    port = roi_max_pool(torch.from_numpy(feat), torch.from_numpy(rois), P,
                        SCALE).numpy()
    oracle = roi_pool_oracle(feat[0], rois[0], P, SCALE)
    assert float(jitted[0, 0, 6].max()) == 5.0
    assert float(eager[0, 0].max()) == 0.0
    np.testing.assert_array_equal(port, eager)
    np.testing.assert_array_equal(port[0], oracle)


def test_roi_max_pool_without_gradient_builds_no_node():
    """Under no_grad, or on a map that needs no gradient, the op returns
    the plain forward with no autograd node (on the card: the kernel with
    no argmax); with a gradient wanted it returns the same values."""
    feat, rois = _inputs(torch.bfloat16, seed=3)
    want = roi_max_pool_plain(feat, rois, P, SCALE)
    plain = roi_max_pool(feat, rois, P, SCALE)
    feat.requires_grad_(True)
    with torch.no_grad():
        served = roi_max_pool(feat, rois, P, SCALE)
    trained = roi_max_pool(feat, rois, P, SCALE)
    assert plain.grad_fn is None and served.grad_fn is None
    assert trained.grad_fn is not None
    for got in (plain, served, trained):
        assert torch.equal(got.detach(), want)


def test_roi_pool_bound_reads_covered_pixels_only():
    """The forward's byte bound reads a map's pixels under some ROI once
    (a ROI's bins tile its clipped rectangle), not the whole map, and
    writes the outputs alone: two overlapping ROIs on map 0, one off the
    map on map 1; a stride-0 map counts the union once."""
    rois = torch.tensor([[[0.0, 0.0, 48.0, 32.0],      # columns 0-3, rows 0-2
                          [32.0, 16.0, 80.0, 48.0]],   # columns 2-5, rows 1-3
                         [[-300.0, -200.0, -40.0, -24.0],
                          [16.0, 16.0, 16.0, 16.0]]])  # cell (1, 1)
    assert map_pixels(rois, 20, 30, "gathered") == 4 * 3 + 4 * 3 - 2 * 2 + 1
    assert map_pixels(rois, 20, 30, "broadcast") == 4 * 3 + 4 * 3 - 2 * 2
    _, by, byts, _ = roi_pool_bound(rois, 20, 30, 8, 2, "gathered")
    assert by == "bytes"
    assert byts == 21 * 8 * 2 + 2 * 2 * 16 + 2 * 2 * P * P * 8 * 2


def test_roi_max_pool_refuses_other_devices():
    feat = torch.zeros((1, 4, 4, 2), device="meta")
    with pytest.raises(ValueError, match="device"):
        roi_max_pool(feat, torch.zeros((1, 1, 4), device="meta"), P, SCALE)


# ---------------------------------------------------------------------------
# the kernels' host plan and their argmax codes (ops/roi_pool_cuda.py); the
# kernels themselves run in tests/test_torch_cuda.py on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,w,fwd,bwd", [
    (40, 64, "smem", "smem"),        # the 640 x 1024 canvas of every path
    (20, 30, "smem", "smem"),        # the card tests' map
    (120, 128, "scan", "bands"),     # past the single-CTA slab
])
def test_slab_plan_fits_shared_memory(dtype, h, w, fwd, bwd):
    """The plan's slab is 32 bytes of a pixel (16 bf16, 8 f32 channels),
    each kernel's shared memory fits the budget a block may opt in to,
    the bands cover the map, and the maps of every path take the
    shared-memory routes."""
    tdt = DTYPES[dtype][0]
    plan = roi_pool_cuda.slab_plan(h, w, 48, tdt)
    elem = torch.empty((), dtype=tdt).element_size()
    assert plan["channels"] * elem == 32
    assert plan["slabs"] == -(-48 // plan["channels"])
    assert plan["forward"]["route"] == fwd
    assert plan["backward"]["route"] == bwd
    if fwd == "smem":
        assert plan["forward"]["smem"] == h * w * 32 + \
            roi_pool_cuda.GEOM_BYTES <= roi_pool_cuda.SMEM_BYTES
    b = plan["backward"]
    assert b["smem"] == b["band_rows"] * w * plan["channels"] * 4 + \
        roi_pool_cuda.GEOM_BYTES <= roi_pool_cuda.SMEM_BYTES - \
        roi_pool_cuda.BWD_STATIC_BYTES
    assert b["bands"] * b["band_rows"] >= h > (b["bands"] - 1) * \
        b["band_rows"]
    assert roi_pool_cuda.SMEM_BYTES <= 227 * 1024


def test_slab_plan_largest_single_cta_maps():
    """The largest maps the shared-memory routes take, as slab_plan states
    them: at a width of 64, 109 rows forward (7006 pixels at most) and 52
    rows for a bf16 map's backward in one band (3375 pixels), 105 for an
    f32 one (6750); a row more takes the global scan or a second band."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert roi_pool_cuda.slab_plan(109, 64, 64, bf16)["forward"]["route"] \
        == "smem"
    assert roi_pool_cuda.slab_plan(110, 64, 64, bf16)["forward"]["route"] \
        == "scan"
    assert roi_pool_cuda.slab_plan(52, 64, 64, bf16)["backward"]["bands"] \
        == 1
    assert roi_pool_cuda.slab_plan(53, 64, 64, bf16)["backward"]["bands"] \
        == 2
    assert roi_pool_cuda.slab_plan(105, 64, 64, f32)["backward"]["bands"] \
        == 1
    assert roi_pool_cuda.slab_plan(106, 64, 64, f32)["backward"]["bands"] \
        == 2
    room = roi_pool_cuda.SMEM_BYTES - roi_pool_cuda.GEOM_BYTES
    assert (room // 32, (room - roi_pool_cuda.BWD_STATIC_BYTES) // 64) == \
        (7006, 3375)


@pytest.mark.parametrize("h,w", [(40, 64), (20, 30), (25, 38)])
def test_max_bin_bounds_every_in_map_roi(h, w):
    """`max_bin` bounds the bins of every ROI whose rounded corners lie on
    the map (all pairs of corners, each axis), so the code type it picks
    (one byte at 40 x 64: 7 x 11 = 77 pixels) never needs the rescan for
    such ROIs."""
    rows, cols = roi_pool_cuda.max_bin(h, w, P)
    for n, bound in ((h, rows), (w, cols)):
        lo, hi = np.triu_indices(n + 1)
        rois = np.zeros((1, len(lo), 4), np.float32)
        rois[0, :, 0] = lo * 16.0
        rois[0, :, 2] = hi * 16.0
        rois[0, :, 3] = 16.0 * n
        _, _, ws, we = roi_pool_bins(torch.from_numpy(rois), P, SCALE, n, n)
        assert int((we - ws).max()) == bound
    assert roi_pool_cuda.max_bin(40, 64, P) == (7, 11)
    assert roi_pool_cuda.slab_plan(40, 64, 512, torch.bfloat16)[
        "code_dtype"] == torch.uint8
    assert roi_pool_cuda.slab_plan(120, 128, 512, torch.bfloat16)[
        "code_dtype"] == torch.uint16


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,w,c", [(20, 30, 16), (20, 30, 48), (20, 30, 50),
                                   (120, 128, 48)])
def test_argmax_codes_round_trip(dtype, h, w, c):
    """`encode_argmax` of the plain argmax (edge ROIs, the oversize ROI,
    windows of ties, empty bins) decodes back to it bit for bit through
    `decode_argmax`: one-byte codes on the small map (the oversize ROI's
    large bins stored as 255 and rescanned), two-byte codes on the large
    one; a partial last slab's padding stays zero."""
    tdt = DTYPES[dtype][0]
    feat, rois, _ = roi_pool_inputs(3, 24, h, w, c, "gathered", "cpu", tdt,
                                    seed=c)
    plan = roi_pool_cuda.slab_plan(h, w, c, tdt)
    want = roi_max_pool_argmax_plain(feat, rois, P, SCALE)
    codes = roi_pool_cuda.encode_argmax(want, rois, P, SCALE, h, w, plan)
    assert codes.dtype == plan["code_dtype"]
    assert tuple(codes.shape) == (3, plan["slabs"], 24, P, P,
                                  plan["channels"])
    assert torch.equal(roi_pool_cuda.decode_argmax(codes, rois, P, SCALE,
                                                   feat), want)
    assert bool((want < 0).any())
    top = torch.iinfo(plan["code_dtype"]).max
    n_top = int((codes.long() == top).sum())
    assert n_top == oversize_bins(rois, h, w, plan["code_dtype"]) * c
    assert (n_top > 0) == (plan["code_dtype"] == torch.uint8)
    pad = plan["slabs"] * plan["channels"] - c
    if pad:
        assert not bool(codes[:, -1, ..., plan["channels"] - pad:].any())


def test_shape_keys_carry_the_kernel():
    """A launch is counted under its shape and the kernel it ran: the
    forward's `forward_kernel` name, the backward's `slab_plan` route."""
    key = roi_pool_cuda.shape_key(16, 256, P, 40, 64, 512, torch.bfloat16,
                                  True, "slab")
    assert key == (16, 256, P, 40, 64, 512, "bfloat16", True, "slab")
    plan = roi_pool_cuda.slab_plan(40, 64, 1024, torch.bfloat16)
    kernel = roi_pool_cuda.forward_kernel(plan, 16, 2, 64, P, 132)[0]
    assert roi_pool_cuda.shape_key(16, 2, P, 40, 64, 1024, torch.bfloat16,
                                   False, kernel)[-1] == "few_rois"
    plan = roi_pool_cuda.slab_plan(120, 128, 48, torch.bfloat16)
    assert roi_pool_cuda.shape_key(
        2, 64, P, 120, 128, 48, torch.bfloat16, True,
        plan["backward"]["route"])[-1] == "bands"


@pytest.mark.parametrize("e,r,slabs,groups", [
    (16, 256, 32, 1),      # training: 512 CTAs already fill 132 SMs
    (16, 1, 32, 1),        # the mask crops
    (1, 300, 32, 9),       # the demo's request: 32 CTAs -> 288
    (4, 300, 32, 3),       # a request of 4 expressions
    (1, 20, 32, 2),        # at least 16 ROIs a group
    (1, 1, 64, 1)])
def test_roi_groups_fill_the_card(e, r, slabs, groups):
    """The shared-memory forward splits an expression's ROIs over CTAs
    only when E x slabs CTAs leave SMs of an H100 (132) idle."""
    assert roi_pool_cuda.roi_groups(e, r, slabs, 132) == groups


@pytest.mark.parametrize("e,r,c,h,w,kernel,arg", [
    (16, 256, 512, 40, 64, "slab", 1),        # training
    (1, 300, 512, 40, 64, "slab", 9),         # the demo's request
    (4, 2, 512, 40, 64, "slab", 1),           # mask crops, 128 CTAs
    (8, 2, 512, 40, 64, "slab", 1),           # mask crops, 256 CTAs
    (16, 1, 512, 40, 64, "few_rois", 1536),   # mask crops, 512 CTAs
    (16, 2, 1024, 40, 64, "few_rois", 1536),  # mask crops, 1024 CTAs
    (1, 1, 512, 40, 64, "few_rois", 1536),    # the demo's mask crop
    (16, 5, 1024, 40, 64, "few_rois", 1536),  # 2 x 49 x 5 = 490 items
    (16, 6, 1024, 40, 64, "slab", 1),         # 588 items: past one CTA
    (1, 2, 512, 4, 1700, "few_rois", 1700),   # a band holds a whole row
    (2, 64, 512, 120, 128, "scan", 1)])       # past the single-CTA slab
def test_forward_kernel_choice(e, r, c, h, w, kernel, arg):
    """Which forward kernel a launch takes, by shape on the host: a few
    ROIs an expression (a thread an item) take the banded kernel where
    the slab kernel's CTAs, two an SM, would take more than one wave of
    an H100's 132 SMs or less than half of one, else the slab kernel; a
    map past the single-CTA slab the global scan."""
    plan = roi_pool_cuda.slab_plan(h, w, c, torch.bfloat16)
    got = roi_pool_cuda.forward_kernel(plan, e, r, w, P, 132)
    assert (got[0], got[2]) == (kernel, arg)
    assert got[1] == {"slab": 0, "scan": 1, "few_rois": 2}[kernel]
