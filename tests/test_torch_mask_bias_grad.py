"""Why the mask upsampler's bias gradient of the port's `response` step
lands 1.08e-4 from JAX's at tests/test_torch_train.py's weights and batch
with the targets of seed 7, and 9-12e-2 from it with oneDNN off.

The bias gradient is the sum of the mask loss's gradient over every
output that the upsampler's ReLU opens, so a flipped opening moves it by
a whole term, however small the pre-activation that flipped. Three
mechanisms, each pinned below on the CPU:

* with oneDNN on (torch's default) two pre-activations, whose exact
  values (a float64 run of layer4 and the upsampler from the same crops)
  are 5.6e-17 and 8.1e-13 against rows of up to 9.8 and 0.41, open on
  opposite sides of the ReLU in oneDNN and XLA, each side rounding one of
  the two to the wrong sign. Those two terms are the whole difference:
  neither package is at fault;
* with oneDNN off, torch's CPU convolution of a batch of 16 or more
  images goes to NNPACK, whose 3 x 3 Winograd transform leaves errors of
  about an ulp of the largest value of its tile, and about 1.5e5 openings
  flip; every one of them is exactly within an f32 ulp of zero against
  its row's largest value, so again no package is at fault. With NNPACK
  off as well, torch's direct convolution differs from XLA at one
  rounding-level opening only, and every gradient leaf of seed 7 lies
  within the gradient test's unchanged 1e-4;
* the two rows whose whole pre-activation is below 1e-6 (mask rows 3 and
  8) are not rounding residues: their ROIs lie where the gate is closed
  (sigmoid near 1e-13), the tail has no bias term, so the row is a tiny
  but exact multiple of an O(1) pattern, and every path opens it alike.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lang2seg_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from lang2seg_tpu.engine.optimizer import partition_params
from lang2seg_tpu.models.heads import _Upsample2x
from lang2seg_tpu.models.network import Lang2Seg as JaxLang2Seg
from lang2seg_tpu_torch.engine.train_state import to_device
from tests.test_torch_train import (_jax_loss_fn, _jax_targets,
                                    _port_grads_as_jax_tree, _targets,
                                    train_config)
from tests.test_torch_weights import _flat, shared_weights

# (oneDNN, NNPACK) for each CPU convolution path of torch
PATHS = {"onednn": (True, True), "direct": (False, False),
         "nnpack": (False, True)}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seed7():
    """tests/test_torch_train.py's weights (seed 4) and batch (seed 5)
    with the targets of seed 7; JAX's losses, gradients and mask
    upsampler pre-activations on them (eager JAX)."""
    cfg = train_config(learning_rate=1e-3)
    model, jmodel, params = shared_weights(cfg, seed=4)
    batch = jsynthetic_batch(cfg, 2, 4, seed=5)
    targets = _targets(cfg, batch, seed=7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jt = _jax_targets(*targets)
    with jax.default_matmul_precision("float32"):
        _, j_grads = jax.value_and_grad(_jax_loss_fn(jmodel, jbatch, jt),
                                        has_aux=True)(params)
        _, state = jmodel.apply(
            {"params": params}, jbatch, jt,
            rngs={"dropout": jax.random.PRNGKey(0),
                  "sampling": jax.random.PRNGKey(1)},
            method=JaxLang2Seg.train_forward,
            capture_intermediates=lambda m, _: isinstance(m, _Upsample2x),
            mutable=["intermediates"])
    j_pre = torch.from_numpy(np.array(
        jax.tree_util.tree_leaves(state["intermediates"])[0]))
    return cfg, model, params, batch, targets, j_grads, j_pre


def _port_pre(model, batch, targets, path):
    """The port's mask upsampler pre-activations (rows, 14, 14, 256), as
    `MaskHead.forward` computes them, on one convolution path; the rows'
    class labels; and the same pre-activations in float64 from the crops
    that path fed layer4 (a float64 copy of layer4 and of the upsampler:
    the exact answer to the rounding of this path's crops)."""
    seen = {}
    hooks = (model.mask_head.register_forward_pre_hook(
        lambda _, args, kwargs: seen.update(x=args[0].detach(),
                                            labels=kwargs["labels"]),
        with_kwargs=True),
        model.backbone.layer4.register_forward_pre_hook(
            lambda _, args: seen.update(crops=args[0].detach())))
    onednn, nnpack = PATHS[path]
    model.train()
    try:
        with torch.no_grad(), torch.backends.mkldnn.flags(enabled=onednn), \
                torch.backends.nnpack.flags(enabled=nnpack):
            model.train_forward(to_device(batch, "cpu"), targets)
    finally:
        for hook in hooks:
            hook.remove()
        model.eval()
    up = model.mask_head.mask_up_sampling
    x = seen["x"].float()
    e, f = targets[1].mask_targets.shape[:2]
    with torch.no_grad():
        exact = copy.deepcopy(model.backbone.layer4).double()(
            seen["crops"].double()).permute(0, 2, 3, 1)
        exact = exact.reshape(e, -1, *exact.shape[1:])[:, :f].reshape(
            e * f, *exact.shape[1:])
    return (_upsample(x, up.weight.detach(), up.bias.detach()),
            seen["labels"],
            _upsample(exact, up.weight.detach().double(),
                      up.bias.detach().double()))


def _upsample(x, weight, bias):
    """`MaskHead.forward`'s pre-activations of (R, S, S, C) features in
    the features' dtype."""
    r, h, w, c = x.shape
    f = weight.shape[1]
    y = torch.matmul(x.reshape(-1, c), weight.reshape(c, f * 4))
    y = y.reshape(r, h, w, f, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(r, 2 * h, 2 * w, f) + bias


def _bias_grad(model, targets, labels, pre):
    """The mask loss's gradient of the upsampler's bias, in float64, from
    the pre-activations `pre` (the head above them as the port has it)."""
    pt = targets[1]
    e, f, s = pt.mask_targets.shape[:3]
    head = model.mask_head.mask_pred_net
    lab = labels.long()
    kcol = head.weight.detach()[:, :, 0, 0].index_select(0, lab).double()
    bcol = head.bias.detach().index_select(0, lab).double()
    pre = pre.double().requires_grad_(True)
    logit = torch.einsum("rhwf,rf->rhw", torch.relu(pre), kcol) \
        + bcol[:, None, None]
    bce = torch.nn.functional.binary_cross_entropy_with_logits(
        logit, pt.mask_targets.reshape(e * f, s, s).double(),
        reduction="none")
    mw = pt.mask_weight.reshape(e * f).double()
    loss = torch.sum(bce * mw[:, None, None]) / (
        max(float(pt.mask_weight.sum()), 1.0) * s * s)
    return torch.autograd.grad(loss, pre)[0].sum(dim=(0, 1, 2))


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _row_max(t):
    return t.abs().amax(dim=(1, 2, 3))


@pytest.mark.parametrize("path", ["onednn", "direct"])
def test_relu_openings_differ_from_xla_only_at_rounding_level(seed7, path):
    """oneDNN, or torch's direct convolution, and XLA open the upsampler's
    ReLU differently at a few outputs only, and the float64 oracle puts
    each of them within rounding of zero: its exact value is below 1e-9 of
    its row's largest magnitude and below the f32 path's own error in that
    row. Those openings carry the whole difference of the bias gradient:
    with XLA's openings the port's pre-activations give XLA's gradient
    within 1e-6."""
    cfg, model, _, batch, targets, _, j_pre = seed7
    pre, labels, exact = _port_pre(model, batch, targets, path)
    flips = (pre > 0) != (j_pre > 0)
    assert 0 < int(flips.sum()) <= 8
    rows = torch.nonzero(flips)[:, 0]
    at = exact.abs()[flips]
    assert bool((at <= 1e-9 * _row_max(exact)[rows]).all())
    assert bool((at < _row_max(pre.double() - exact)[rows]).all())
    want = _bias_grad(model, targets, labels, j_pre)
    relu_as_xla = torch.where(flips, j_pre, pre)
    assert _rel(_bias_grad(model, targets, labels, relu_as_xla),
                want) <= 1e-6
    if path == "onednn":
        assert _rel(_bias_grad(model, targets, labels, pre), want) > 1e-5


def test_nnpack_winograd_flips_upsampler_openings(seed7):
    """With oneDNN off and NNPACK on, the tail's 3 x 3 convolution of the
    batch of crops runs as NNPACK's Winograd: layer4's output, next to
    large values, is off by up to about an ulp of them (more than 1e-7
    absolute where the direct convolution is within 1e-9 of it), and more
    than 1e4 openings flip, moving the bias gradient by more than 1e-2.
    The float64 oracle puts every flipped opening within rounding of zero
    all the same: below an f32 ulp (1.2e-7) of its row's largest
    magnitude and below the NNPACK path's own error in that row."""
    if not torch.backends.nnpack.is_available():
        pytest.skip("this torch build has no NNPACK, so no Winograd path")
    cfg, model, _, batch, targets, _, j_pre = seed7
    pre, labels, exact = _port_pre(model, batch, targets, "nnpack")
    direct, _, _ = _port_pre(model, batch, targets, "direct")
    flips = (pre > 0) != (j_pre > 0)
    assert int(flips.sum()) > 10_000
    assert float((pre - direct).detach().abs().max()) > 1e-7
    rows = torch.nonzero(flips)[:, 0]
    at = exact.abs()[flips]
    assert bool((at <= 1.2e-7 * _row_max(exact)[rows]).all())
    assert bool((at < _row_max(pre.double() - exact)[rows]).all())
    want = _bias_grad(model, targets, labels, j_pre)
    assert _rel(_bias_grad(model, targets, labels, pre), want) > 1e-2


def test_small_mask_rows_are_exact_not_residues(seed7):
    """Mask rows 3 and 8, whose every pre-activation is below 1e-6, open
    alike on every path and in XLA: their inputs are small but exact
    (the gate closed over their ROIs), not rounding residues."""
    cfg, model, _, batch, targets, _, j_pre = seed7
    row_max = j_pre.abs().amax(dim=(1, 2, 3))
    small = torch.nonzero(row_max < 1e-6)[:, 0].tolist()
    assert small == [3, 8]
    for path in PATHS:
        pre, _, _ = _port_pre(model, batch, targets, path)
        assert torch.equal(pre[small] > 0, j_pre[small] > 0), path
        for row in small:
            assert float((pre[row] - j_pre[row]).abs().max()) <= \
                1e-4 * float(row_max[row]), (path, row)


def test_gradients_match_jax_with_direct_convolution(seed7):
    """tests/test_torch_train.py's gradient test (each trainable leaf
    within 1e-4 in relative L2 norm) at the targets of seed 7, with the
    port on torch's direct CPU convolution (oneDNN and NNPACK off):
    mask_up_sampling.bias included, every leaf passes."""
    cfg, model, params, batch, targets, j_grads, _ = seed7
    model.train()
    model.zero_grad(set_to_none=True)
    with torch.backends.mkldnn.flags(enabled=False), \
            torch.backends.nnpack.flags(enabled=False):
        losses = model.train_forward(to_device(batch, "cpu"), targets)
        losses["total_loss"].backward()
    model.eval()
    got = _flat(_port_grads_as_jax_tree(model, cfg))
    want = _flat(j_grads)
    trainable, _ = partition_params(params, cfg)
    checked = 0
    for key, leaf in _flat(trainable).items():
        if leaf is None:
            continue
        w, g = np.asarray(want[key]), np.asarray(got[key])
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 1e-4, key
        checked += 1
    assert checked >= 40
    model.zero_grad(set_to_none=True)
