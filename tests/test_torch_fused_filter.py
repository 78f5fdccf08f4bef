"""The port's plain fused gate (lang2seg_tpu_torch.ops.fused_filter, the CPU
path and the oracle of the CUDA kernel) against the JAX package: its
Pallas kernel `fused_dynamic_filter` run in interpret mode, and the plain
path of `models/dynamic_filter.py::DynamicFilterGen`, for K in {1, 7} and
both gates.

Tolerances: f32 maps at 1e-4 (the (H*W, C) x (C, K) contraction is summed
in another order). bf16 maps: the port follows the Pallas kernel, which
rounds the f32 product conv * g once to bf16; the plain JAX path casts g
to bf16 first and rounds the bf16 product, so gated may differ there by
one bf16 ulp."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lang2seg_tpu.models.dynamic_filter import (DynamicFilterGen as
                                                JaxDynamicFilterGen)
from lang2seg_tpu.models.dynamic_filter import spatial_masks_7 as jmasks
from lang2seg_tpu.ops.pallas_kernels import fused_dynamic_filter as jfused
from lang2seg_tpu_torch.models.dynamic_filter import (DynamicFilterGen,
                                                      spatial_masks_7)
from lang2seg_tpu_torch.ops import fused_filter
from lang2seg_tpu_torch.ops.fused_filter import fused_dynamic_filter_plain
from lang2seg_tpu_torch.utils import trace

CASES = [(7, "sigmoid"), (7, "multiply"), (1, "sigmoid"), (1, "multiply")]


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in bf16 representable steps."""
    def ordered(x):
        bits = x.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (ordered(a) - ordered(b)).abs()


def _inputs(rng, k, b=2, h=8, w=16, c=128):
    net_conv = rng.randn(b, h, w, c).astype(np.float32)
    filt = np.tanh(rng.randn(b, c, k)).astype(np.float32)
    rfilt = np.tanh(rng.randn(b, k)).astype(np.float32)
    return net_conv, filt, rfilt


def test_spatial_masks_identical():
    for h, w in ((8, 16), (40, 64), (7, 13)):
        np.testing.assert_array_equal(spatial_masks_7(h, w).numpy(),
                                      np.asarray(jmasks(h, w)))


@pytest.mark.parametrize("k,gate", CASES)
@pytest.mark.parametrize("normalize", [True, False])
def test_plain_matches_pallas_interpret(rng, k, gate, normalize):
    net_conv, filt, rfilt = _inputs(rng, k)
    if k == 1:
        rfilt = np.ones_like(rfilt)
    want_g, want_r = jfused(jnp.asarray(net_conv), jnp.asarray(filt),
                            jnp.asarray(rfilt), num_filters=k, gate=gate,
                            normalize=normalize, interpret=True)
    got_g, got_r = fused_dynamic_filter_plain(
        torch.from_numpy(net_conv), torch.from_numpy(filt),
        torch.from_numpy(rfilt), k, gate, normalize)
    assert got_r.shape == (2, 8, 16, 1) and got_r.dtype == torch.float32
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-4)


def _jax_filter_gen(k, gate, hidden_dim, c, rng):
    mod = JaxDynamicFilterGen(c4_dim=c, num_filters=k, gate=gate,
                              normalize=True)
    params = {"dynamic_fc": {
        "kernel": (rng.randn(hidden_dim, c * k) * 0.05).astype(np.float32),
        "bias": (rng.randn(c * k) * 0.05).astype(np.float32)}}
    if k == 7:
        params["response_fc"] = {
            "kernel": (rng.randn(hidden_dim, k) * 0.2).astype(np.float32),
            "bias": (rng.randn(k) * 0.1).astype(np.float32)}
    return mod, params


def _port_filter_gen(k, gate, hidden_dim, c, params):
    mod = DynamicFilterGen(hidden_dim, c, k, gate, normalize=True)
    kern, bias = params["dynamic_fc"]["kernel"], params["dynamic_fc"]["bias"]
    with torch.no_grad():
        if k == 1:
            mod.dynamic_fc.weight.copy_(torch.from_numpy(kern.T))
            mod.dynamic_fc.bias.copy_(torch.from_numpy(bias))
        else:
            for i in range(k):
                fc = getattr(mod, f"dynamic_fc_{i}")
                fc.weight.copy_(torch.from_numpy(kern[:, i * c:(i + 1) * c].T))
                fc.bias.copy_(torch.from_numpy(bias[i * c:(i + 1) * c]))
            mod.response_fc.weight.copy_(
                torch.from_numpy(params["response_fc"]["kernel"].T))
            mod.response_fc.bias.copy_(
                torch.from_numpy(params["response_fc"]["bias"]))
    return mod


@pytest.mark.parametrize("k,gate", CASES)
def test_filter_gen_matches_jax_plain_path(rng, k, gate):
    """The whole conditioning module (Dense -> tanh filters -> gate) on a
    broadcast f32 map against the JAX module's plain einsum path."""
    e, h, w, c, d = 3, 8, 12, 256, 64
    jmod, params = _jax_filter_gen(k, gate, d, c, rng)
    pmod = _port_filter_gen(k, gate, d, c, params)
    conv1 = rng.randn(1, h, w, c).astype(np.float32)
    hidden = rng.randn(e, d).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want_g, want_r = jmod.apply(
            {"params": params},
            jnp.broadcast_to(jnp.asarray(conv1), (e, h, w, c)),
            jnp.asarray(hidden))
    with torch.no_grad():
        got_g, got_r = pmod(torch.from_numpy(conv1).expand(e, h, w, c),
                            torch.from_numpy(hidden))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,gate", [(7, "sigmoid"), (1, "multiply")])
def test_bf16_within_one_ulp_of_jax_plain_path(rng, k, gate):
    net_conv, filt, rfilt = _inputs(rng, k, c=256)
    if k == 1:
        rfilt = np.ones_like(rfilt)
    conv_bf = jnp.asarray(net_conv).astype(jnp.bfloat16)
    # the plain JAX path of DynamicFilterGen (models/dynamic_filter.py)
    resp = jnp.einsum("bhwc,bck->bhwk", conv_bf.astype(jnp.float32),
                      jnp.asarray(filt), precision="highest")
    resp = resp / jnp.sqrt(jnp.float32(256))
    if k == 7:
        resp = resp * jmasks(8, 16).transpose(1, 2, 0)[None]
        fused = jnp.einsum("bhwk,bk->bhw", resp, jnp.asarray(rfilt),
                           precision="highest")[..., None]
    else:
        fused = resp
    g = jax.nn.sigmoid(fused) if gate == "sigmoid" else fused
    want = conv_bf * g.astype(jnp.bfloat16)

    conv_t = torch.from_numpy(np.array(conv_bf.astype(jnp.float32))
                              ).to(torch.bfloat16)
    got_g, got_r = fused_dynamic_filter_plain(
        conv_t, torch.from_numpy(filt), torch.from_numpy(rfilt), k, gate,
        True)
    assert got_g.dtype == torch.bfloat16
    np.testing.assert_allclose(got_r.numpy(), np.asarray(fused),
                               rtol=1e-4, atol=1e-4)
    want_t = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert int(bf16_ulp_distance(got_g.float(), want_t).max()) <= 1


def test_wrapper_takes_plain_path_on_cpu(rng):
    net_conv, filt, rfilt = _inputs(rng, 7)
    args = (torch.from_numpy(net_conv), torch.from_numpy(filt),
            torch.from_numpy(rfilt))
    before = trace.counters().get("gate.launches", 0)
    g1, r1 = fused_filter.fused_dynamic_filter(*args, 7, "sigmoid", True)
    g2, r2 = fused_dynamic_filter_plain(*args, 7, "sigmoid", True)
    assert torch.equal(g1, g2) and torch.equal(r1, r2)
    assert trace.counters().get("gate.launches", 0) == before
    with pytest.raises(ValueError):
        fused_filter.fused_dynamic_filter(*(a.to("meta") for a in args))


# (e, h, w): the flagship map, maps that end mid-tile, one and 17
# expressions, more expressions than two an SM, a single pixel
PLAN_SHAPES = [(16, 40, 64), (1, 9, 20), (17, 9, 20), (3, 9, 20),
               (1, 40, 64), (300, 8, 8), (2, 1, 1)]


def _plan_pixels(plan, h, w):
    """The pixel ranges each block of one expression covers, as the
    kernels walk them: block b takes tiles [b * tiles_per_block, ...)."""
    npix, tp, per = h * w, plan["tile_pixels"], plan["tiles_per_block"]
    return [range(min(b * per * tp, npix), min((b + 1) * per * tp, npix))
            for b in range(plan["blocks_per_expr"])]


# pixels a tile of the kernels the card runs at C = 1024: 8 (bf16
# backward), 16 (bf16 forward), 32 (f32 forward at C = 256)
@pytest.mark.parametrize("tile_pixels", [8, 16, 32])
@pytest.mark.parametrize("e,h,w", PLAN_SHAPES)
def test_tile_plan_covers_every_pixel_once(e, h, w, tile_pixels):
    plan = fused_filter.tile_plan(e, h, w, tile_pixels, 2, 132)
    ranges = _plan_pixels(plan, h, w)
    covered = np.zeros(h * w, int)
    for r in ranges:
        assert len(r) > 0                      # no block left empty
        covered[r.start:r.stop] += 1
    assert (covered == 1).all()
    assert plan["grid"] == (plan["blocks_per_expr"], e)
    assert plan["tiles_per_expr"] * tile_pixels >= h * w
    # one wave of two blocks an SM whenever the expressions allow it
    assert e * plan["blocks_per_expr"] <= max(2 * 132, e)


def test_tile_plan_at_the_flagship_shape():
    """(16, 40, 64, 1024) bf16 on an H100's 132 SMs, as PERF.md states:
    256 blocks, one wave of two an SM; the backward walks 20 tiles of 8
    pixels a block, the forward 10 tiles of 16."""
    bwd = fused_filter.tile_plan(16, 40, 64, 8, 2, 132)
    fwd = fused_filter.tile_plan(16, 40, 64, 16, 2, 132)
    assert (bwd["tiles_per_block"], bwd["grid"]) == (20, (16, 16))
    assert (fwd["tiles_per_block"], fwd["grid"]) == (10, (16, 16))


def _cotangents(rng, net_conv):
    return (rng.randn(*net_conv.shape).astype(np.float32),
            rng.randn(*net_conv.shape[:3], 1).astype(np.float32))


@pytest.mark.parametrize("k,gate", CASES)
@pytest.mark.parametrize("normalize", [True, False])
def test_plain_bwd_matches_pallas_vjp(rng, k, gate, normalize):
    """The plain backward against jax.vjp of the Pallas kernel (interpret
    mode), i.e. its custom_vjp rule `_fdf_bwd`, in f32: within 1e-5 of
    each gradient's largest magnitude (sums taken in another order)."""
    net_conv, filt, rfilt = _inputs(rng, k)
    if k == 1:
        rfilt = np.ones_like(rfilt)
    d_gated, d_resp = _cotangents(rng, net_conv)
    (_, resp), vjp = jax.vjp(
        lambda x, f, r: jfused(x, f, r, num_filters=k, gate=gate,
                               normalize=normalize, interpret=True),
        jnp.asarray(net_conv), jnp.asarray(filt), jnp.asarray(rfilt))
    want = vjp((jnp.asarray(d_gated), jnp.asarray(d_resp)))
    got = fused_filter.fused_dynamic_filter_bwd_plain(
        torch.from_numpy(net_conv), torch.from_numpy(filt),
        torch.from_numpy(rfilt), torch.from_numpy(np.array(resp)),
        torch.from_numpy(d_gated), torch.from_numpy(d_resp), k, gate,
        normalize)
    for name, g, w in zip(("d_conv", "d_filt", "d_rfilt"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("k,gate", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_matches_autograd_of_plain(rng, k, gate, dtype):
    """fused_dynamic_filter on CPU tensors (the autograd Function with the
    plain backward) against torch autograd through the plain forward.
    bf16 maps: both round d_conv once to bf16 from nearly the same f32
    value, so they may differ by one bf16 ulp."""
    net_conv, filt, rfilt = _inputs(rng, k)
    d_gated, d_resp = _cotangents(rng, net_conv)
    grads = []
    for fn in (fused_filter.fused_dynamic_filter, fused_dynamic_filter_plain):
        x = torch.from_numpy(net_conv).to(dtype).requires_grad_(True)
        f = torch.from_numpy(filt).requires_grad_(True)
        r = torch.from_numpy(rfilt).requires_grad_(True)
        gated, resp = fn(x, f, r, k, gate, True)
        loss = ((gated.float() * torch.from_numpy(d_gated)).sum()
                + (resp * torch.from_numpy(d_resp)).sum())
        grads.append(torch.autograd.grad(loss, (x, f, r), allow_unused=True,
                                         materialize_grads=True))
    (dx, df, dr), (px, pf, pr) = grads
    assert dx.dtype == dtype
    if dtype == torch.bfloat16:
        assert int(bf16_ulp_distance(dx.float(), px.float()).max()) <= 1
        tol = 1e-3           # d_filt sums conv in bf16-rounded values
    else:
        tol = 1e-5
        np.testing.assert_allclose(dx.numpy(), px.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(px.abs().max()))
    for a, b in ((df, pf), (dr, pr)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol,
                                   atol=tol * max(float(b.abs().max()), 1e-30))
    if k == 1:
        assert float(dr.abs().max()) == 0.0
