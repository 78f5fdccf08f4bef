"""The gate's per-image map read (`exprs_per_map`, G): expression e reads
map e // G, so that an eval dispatch of N images x S expressions gates
each image's map in place. The plain version (the CPU path and the
kernel's oracle) with G must equal the call on the maps repeated G times
bit for bit, and match the JAX package's Pallas kernel (interpret mode,
as the JAX tests run it) on the repeated maps to tests/
test_torch_fused_filter.py's tolerance (1e-4: the contraction is summed
in another order). The backward takes one map an expression, or one map
for all of them; maps shared by some expressions raise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lang2seg_tpu.ops.pallas_kernels import fused_dynamic_filter as jfused
from lang2seg_tpu_torch.ops import fused_filter
from lang2seg_tpu_torch.ops.fused_filter import (fused_dynamic_filter,
                                                 fused_dynamic_filter_bwd,
                                                 fused_dynamic_filter_plain,
                                                 per_expression)

E = 4
GROUPS = [1, 2, E]
GATES = [(7, "sigmoid", True), (7, "multiply", False), (1, "sigmoid", True)]


def _inputs(seed, g, k, dtype=torch.float32, h=8, w=16, c=128):
    """E // g maps and the filters of E expressions, from a numpy seed."""
    rng = np.random.RandomState(seed)
    maps = torch.from_numpy(rng.randn(E // g, h, w, c).astype(np.float32))
    filt = torch.from_numpy(np.tanh(rng.randn(E, c, k)).astype(np.float32))
    rfilt = torch.from_numpy(np.tanh(rng.randn(E, k)).astype(np.float32))
    if k == 1:
        rfilt = torch.ones_like(rfilt)
    return maps.to(dtype), filt, rfilt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,gate,normalize", GATES)
@pytest.mark.parametrize("g", GROUPS)
def test_grouped_read_equals_repeated_maps(g, k, gate, normalize, dtype):
    """plain(maps, G) and the wrapper on the CPU give the bits of
    plain(maps.repeat_interleave(G, 0))."""
    maps, filt, rfilt = _inputs(g, g, k, dtype)
    want = fused_dynamic_filter_plain(maps.repeat_interleave(g, 0), filt,
                                      rfilt, k, gate, normalize)
    got = fused_dynamic_filter_plain(maps, filt, rfilt, k, gate, normalize,
                                     exprs_per_map=g)
    via = fused_dynamic_filter(maps, filt, rfilt, k, gate, normalize,
                               exprs_per_map=g)
    for a, b, c in zip(got, via, want):
        assert a.shape == c.shape and a.dtype == c.dtype
        assert torch.equal(a, c) and torch.equal(b, c)


@pytest.mark.parametrize("k,gate,normalize", GATES)
@pytest.mark.parametrize("g", GROUPS)
def test_grouped_read_matches_pallas_interpret(g, k, gate, normalize):
    maps, filt, rfilt = _inputs(10 + g, g, k)
    rep = np.repeat(maps.numpy(), g, axis=0)
    want_g, want_r = jfused(jnp.asarray(rep), jnp.asarray(filt.numpy()),
                            jnp.asarray(rfilt.numpy()), num_filters=k,
                            gate=gate, normalize=normalize, interpret=True)
    got_g, got_r = fused_dynamic_filter_plain(maps, filt, rfilt, k, gate,
                                              normalize, exprs_per_map=g)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-4)


def test_one_map_for_all_is_the_broadcast_read():
    """One map for all E expressions goes in as today's stride-0
    broadcast: a view, no copy, and the same gradients as the broadcast
    map's."""
    maps, filt, rfilt = _inputs(5, E, 7)
    assert per_expression(maps, E).stride(0) == 0
    a = maps.clone().requires_grad_(True)
    b = maps.clone().requires_grad_(True)
    ga, ra = fused_dynamic_filter(a, filt, rfilt, 7, "sigmoid", True,
                                  exprs_per_map=E)
    gb, rb = fused_dynamic_filter(b.expand(E, *b.shape[1:]), filt, rfilt, 7,
                                  "sigmoid", True)
    (ga.sum() + ra.sum()).backward()
    (gb.sum() + rb.sum()).backward()
    assert torch.equal(ga, gb) and torch.equal(ra, rb)
    assert torch.equal(a.grad, b.grad)


def test_shared_maps_have_no_backward_yet():
    """1 < G < E: the forward runs, its backward and the backward
    wrapper raise (the training gather's read comes with ROADMAP Queue 1
    #5.5)."""
    maps, filt, rfilt = _inputs(6, 2, 7)
    x = maps.clone().requires_grad_(True)
    gated, resp = fused_dynamic_filter(x, filt, rfilt, 7, "sigmoid", True,
                                       exprs_per_map=2)
    with pytest.raises(NotImplementedError, match="Queue 1 #5.5"):
        (gated.sum() + resp.sum()).backward()
    with pytest.raises(NotImplementedError, match="Queue 1 #5.5"):
        fused_dynamic_filter_bwd(
            maps, filt, rfilt, resp.detach(), torch.ones_like(gated),
            torch.zeros_like(resp), 7, "sigmoid", True, exprs_per_map=2)


def test_grouped_read_checks_its_counts():
    maps, filt, rfilt = _inputs(7, 2, 7)
    for g in (0, 3):
        with pytest.raises(ValueError, match="maps"):
            fused_dynamic_filter(maps, filt, rfilt, 7, "sigmoid", True,
                                 exprs_per_map=g)


def test_grouped_plans_count_every_expression(monkeypatch):
    """The launch plan of N maps read by G expressions each is the plan
    of N * G expressions (the tiling, which a CUDA build reports, and the
    SM count are given here)."""
    monkeypatch.setattr(fused_filter, "_tiling", lambda *a: (16, 2))
    monkeypatch.setattr(fused_filter, "_sms", lambda index: 132)
    maps = torch.empty((4, 40, 64, 1024), dtype=torch.bfloat16)
    plan = fused_filter.launch_plan("forward", maps, exprs_per_map=16)
    assert plan["grid"][1] == 64
    assert plan == fused_filter.launch_plan(
        "forward", maps[:1].expand(64, 40, 64, 1024))
