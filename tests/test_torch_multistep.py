"""Several SGD steps a call (`engine/train_state.py::make_multi_train_step`)
and the Trainer's grouping of them, on the CPU at the tiny `response`
config (resnet26, 128x192, f32): K steps a call against K `train_step`
calls bit for bit, against K JAX steps with injected targets, the
graph-replayable SGD against torch's own, the mask head's one-hot class
gather, and the Trainer's groups,
batches and snapshots at steps_per_dispatch > 1. On the CPU the call
takes K eager steps; its CUDA graph is held bit for bit against the eager
steps on the card (chip_smoke.py phase 28)."""

import copy
import os

import numpy as np
import pytest
import torch

from lang2seg_tpu_torch.data.synthetic import (FixedBatchLoader,
                                              synthetic_batch, to_wire)
from lang2seg_tpu_torch.engine import trainer as trainer_mod
from lang2seg_tpu_torch.engine.optimizer import SGD, param_groups, set_lr
from lang2seg_tpu_torch.engine.train_state import (create_train_state,
                                                   make_multi_train_step,
                                                   stack_batches, to_device,
                                                   train_step)
from lang2seg_tpu_torch.engine.trainer import Trainer
from tests.test_torch_weights import response_config, to_port_cfg


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batches(cfg, n, uid=False):
    out = []
    for s in range(n):
        b = to_wire(cfg, synthetic_batch(cfg, 2, 4, seed=10 + s))
        if uid:
            b["expr_uid"] = np.arange(4, dtype=np.int32) + 4 * s
        out.append(b)
    return out


def _momentum(state):
    opt = state.optimizer
    return [opt.state[p]["momentum_buffer"]
            for g in opt.param_groups for p in g["params"]]


def _assert_states_equal(a, b):
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name
    for x, y in zip(_momentum(a), _momentum(b)):
        assert torch.equal(x, y)
    assert a.step == b.step


@pytest.mark.parametrize("uid", [False, True], ids=["generator", "expr_uid"])
def test_multi_step_equals_single_steps(uid):
    """K = 3 steps a call, with word dropout and the samplers drawing from
    the generator (or, with expr_uid, the per-example draws under a
    per-step key) and an LR boundary after the second step: parameters,
    momentum buffers, the generator's state and every step's losses equal
    3 train_step calls bit for bit."""
    cfg = to_port_cfg(response_config())
    cfg.train.stepsize = (2,)
    batches = _batches(cfg, 3, uid)
    a = create_train_state(cfg, device="cpu", seed=1)
    b = create_train_state(cfg, device="cpu", seed=1)
    ga, gb = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    want = [train_step(a, to_device(x, "cpu"), ga) for x in batches]
    multi = make_multi_train_step(b, gb)
    assert not multi.graphed
    got = multi(to_device(stack_batches(batches), "cpu"))
    assert set(got) == set(want[0])
    for k, v in got.items():
        assert v.shape == (3,)
        assert torch.equal(v, torch.stack([w[k] for w in want])), k
    _assert_states_equal(a, b)
    assert torch.equal(ga.get_state(), gb.get_state())
    assert [g["lr"] for g in b.optimizer.param_groups] == \
        [g["lr"] for g in a.optimizer.param_groups]


def test_sgd_equals_torch_sgd_bit_for_bit():
    """The port's SGD update (the LR read from its device tensors, filled
    by set_lr) takes torch SGD's steps bit for bit on the CPU, across an
    LR boundary; its state dict loads into torch SGD and back."""
    cfg = to_port_cfg(response_config())
    cfg.train.stepsize = (1,)
    models = [create_train_state(cfg, device="cpu", seed=2).model
              for _ in range(2)]
    ours = SGD(param_groups(models[0], cfg), lr=cfg.train.learning_rate,
               momentum=cfg.train.momentum)
    ref = torch.optim.SGD(param_groups(models[1], cfg),
                          lr=cfg.train.learning_rate,
                          momentum=cfg.train.momentum, dampening=0.0,
                          nesterov=False)
    g = torch.Generator().manual_seed(0)
    for step in range(3):
        grads = {n: torch.randn(p.shape, generator=g)
                 for n, p in models[0].named_parameters() if p.requires_grad}
        for m in models:
            for n, p in m.named_parameters():
                if p.requires_grad:
                    p.grad = grads[n].clone()
        for opt in (ours, ref):
            set_lr(opt, cfg, step)
            opt.step()
        assert [float(t) for t in ours.neg_lr] == \
            [-float(np.float32(gr["lr"])) for gr in ours.param_groups]
    for (n, x), y in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        assert torch.equal(x, y), n
    ref.load_state_dict(ours.state_dict())
    ours.load_state_dict(ref.state_dict())


def test_sgd_update_reads_the_lr_tensors():
    """The update takes each group's LR from its tensor, not from the
    group's float: a captured step replays with the LR set_lr filled in
    before the replay."""
    cfg = to_port_cfg(response_config())
    model = create_train_state(cfg, device="cpu", seed=2).model
    opt = SGD(param_groups(model, cfg), lr=cfg.train.learning_rate,
              momentum=0.0)
    params = [p for g in opt.param_groups for p in g["params"]]
    before = [p.detach().clone() for p in params]
    for p in params:
        p.grad = torch.ones_like(p)
    for g, neg_lr in zip(opt.param_groups, opt.neg_lr):
        g["weight_decay"] = 0.0
        neg_lr.fill_(-0.5)
    opt.step()
    for p, b in zip(params, before):
        assert torch.equal(p.detach(), b - 0.5)


def _recording_trainer(tmp_path, monkeypatch, k, snapshot_iters, max_iters):
    """A CPU Trainer whose steps only count and record which batches they
    took (each batch is tagged by its im_hw[0, 0])."""
    cfg = to_port_cfg(response_config())
    cfg.train.snapshot_iters = snapshot_iters
    cfg.train.steps_per_dispatch = k
    cfg.train.display = 100
    base = synthetic_batch(cfg, 2, 4, seed=0)
    batches = []
    for i in range(max_iters + 4):
        b = dict(base, im_hw=base["im_hw"].copy())
        b["im_hw"][0, 0] = i
        batches.append(b)
    tr = Trainer(cfg, FixedBatchLoader(batches), str(tmp_path / "run"),
                 device="cpu")
    calls = []

    def single(state, batch, generator):
        calls.append(("single", [int(batch["im_hw"][0, 0])]))
        state.step += 1
        return {"total_loss": torch.tensor(1.0)}

    def multi(stacked):
        tags = [int(v) for v in stacked["im_hw"][:, 0, 0]]
        calls.append(("multi", tags))
        tr.state.step += len(tags)
        return {"total_loss": torch.ones(len(tags))}

    monkeypatch.setattr(trainer_mod, "train_step", single)
    tr.multi_step = multi
    # the snapshots' iterations, in order (no weights written)
    tr.snapshots = []
    tr.snapshot = tr.snapshots.append
    return tr, calls


def test_trainer_multi_step_grouping(tmp_path, monkeypatch):
    """JAX test_trainer_multi_step_grouping: K = 3 with snapshots every 4
    up to 6 runs the groups [3], [1], [1], [1] (no group crosses the
    snapshot at 4 or the end), takes the batches in loader order with
    none skipped or repeated, and snapshots at 4 and 6."""
    tr, calls = _recording_trainer(tmp_path, monkeypatch, 3, 4, 6)
    tr.train(max_iters=6)
    assert [c[0] for c in calls] == ["multi", "single", "single", "single"]
    assert [len(c[1]) for c in calls] == [3, 1, 1, 1]
    assert [t for c in calls for t in c[1]] == list(range(6))
    assert tr.state.step == 6
    assert tr.snapshots == [4, 6]
    assert tr.loader.position == 6


def test_trainer_groups_stop_at_lr_boundaries(tmp_path, monkeypatch):
    """An LR decay at 5 with snapshots every 8, K = 2, 10 steps: groups
    [2], [2], [1] (the decay snapshot), [2], [1] (the cadence at 8),
    [2]; snapshots at 5, 8 and 10."""
    tr, calls = _recording_trainer(tmp_path, monkeypatch, 2, 8, 10)
    tr.cfg.train.stepsize = (5,)
    tr.train(max_iters=10)
    assert [len(c[1]) for c in calls] == [2, 2, 1, 2, 1, 2]
    assert [t for c in calls for t in c[1]] == list(range(10))
    assert tr.snapshots == [5, 8, 10]


def test_trainer_steps_per_dispatch_equals_single_steps(tmp_path):
    """A 4-step CPU Trainer at steps_per_dispatch 2 (two real multi-step
    calls) ends with the weights, momentum and generator of the Trainer at
    1, and its snapshot resumes to the same place."""
    cfg = to_port_cfg(response_config())
    cfg.train.snapshot_iters = 4
    batches = _batches(cfg, 4)
    runs = {}
    for k in (1, 2):
        c = copy.deepcopy(cfg)
        c.train.steps_per_dispatch = k
        tr = Trainer(c, FixedBatchLoader(batches),
                     str(tmp_path / f"k{k}") if k == 2 else None,
                     device="cpu")
        tr.train(4)
        runs[k] = tr
    _assert_states_equal(runs[1].state, runs[2].state)
    assert torch.equal(runs[1].generator.get_state(),
                       runs[2].generator.get_state())
    assert os.listdir(tmp_path / "k2" / "ckpt") == ["iter_4"]


def test_multi_step_matches_jax_steps():
    """K = 2 steps a call with injected targets (word dropout off) against
    two JAX steps: its train_forward gradients at each step's weights
    through its optimizer chain (clipping at 10, momentum carried). Every
    leaf's update over the two steps within 1e-4 in relative L2 norm, the
    tolerance of test_torch_train.py::test_train_step_matches_jax_step,
    and each step's total loss within 1e-4 relative."""
    import jax
    import jax.numpy as jnp
    import optax
    from lang2seg_tpu.data.synthetic import synthetic_batch as jbatch
    from lang2seg_tpu.engine.convert import convert_torch_state_dict
    from lang2seg_tpu.engine.optimizer import (build_optimizer,
                                               merge_params,
                                               partition_params)
    from tests.test_torch_train import (_jax_loss_fn, _jax_targets,
                                        _targets, train_config)
    from tests.test_torch_weights import _flat, shared_weights

    cfg = train_config(learning_rate=0.1)
    model, jmodel, params = shared_weights(cfg, seed=4)
    batches = [jbatch(cfg, 2, 4, seed=5 + s) for s in range(2)]
    targets = [_targets(cfg, b, seed=6 + s) for s, b in enumerate(batches)]

    state = create_train_state(to_port_cfg(cfg), device="cpu",
                               state_dict=model.state_dict())
    losses = make_multi_train_step(state, None)(
        to_device(stack_batches(batches), "cpu"), targets)
    got = _flat(convert_torch_state_dict(
        {k: v.detach().numpy() for k, v in state.model.state_dict().items()},
        cfg))

    old = _flat(params)
    trainable, frozen = partition_params(params, cfg)
    tx = build_optimizer(trainable, cfg)
    opt_state = tx.init(trainable)
    for s, (b, t) in enumerate(zip(batches, targets)):
        full = merge_params(trainable, frozen)
        with jax.default_matmul_precision("float32"):
            (_, j_losses), grads = jax.value_and_grad(
                _jax_loss_fn(jmodel, {k: jnp.asarray(v) for k, v in b.items()},
                             _jax_targets(*t)), has_aux=True)(full)
        assert abs(float(losses["total_loss"][s])
                   - float(j_losses["total_loss"])) <= \
            1e-4 * abs(float(j_losses["total_loss"]))
        g_tr, _ = partition_params(grads, cfg)
        updates, opt_state = tx.update(g_tr, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
    want = _flat(merge_params(trainable, frozen))
    checked = 0
    for key, w in want.items():
        d_w = np.asarray(w) - np.asarray(old[key])
        d_g = np.asarray(got[key]) - np.asarray(old[key])
        if not np.any(d_w):
            assert not np.any(d_g), key
            continue
        assert np.linalg.norm(d_g - d_w) / np.linalg.norm(d_w) <= 1e-4, key
        checked += 1
    assert checked >= 40


@pytest.mark.parametrize("classes", [3, 81], ids=["shared", "spread"])
def test_mask_head_class_gather(classes):
    """The mask head takes each row's class column and bias by a one-hot
    product: the logits equal those of index_select's gather bit for bit,
    the gradients of the class weights and biases equal index_select's up
    to the order of each class's sum, the same bits on every call. With 3
    classes many rows share one."""
    from lang2seg_tpu_torch.models.heads import MaskHead
    g = torch.Generator().manual_seed(classes)
    head = MaskHead(in_features=64, num_classes=81, features=32)
    x = torch.randn((40, 7, 7, 64), generator=g)
    labels = torch.randint(0, classes, (40,), generator=g)
    cot = torch.randn((40, 14, 14), generator=g)
    w, bias = head.mask_pred_net.weight, head.mask_pred_net.bias

    def plain():
        up = head.mask_up_sampling
        y = torch.matmul(x.reshape(-1, 64), up.weight.reshape(64, 32 * 4))
        y = y.reshape(40, 7, 7, 32, 2, 2).permute(0, 1, 4, 2, 5, 3)
        y = torch.relu(y.reshape(40, 14, 14, 32) + up.bias)
        kcol = w[:, :, 0, 0].index_select(0, labels)
        return torch.einsum("rhwf,rf->rhw", y, kcol) + \
            bias.index_select(0, labels)[:, None, None]
    out = head(x, labels)
    assert torch.equal(out, plain())
    got = [torch.autograd.grad((head(x, labels) * cot).sum(), (w, bias))
           for _ in range(2)]
    want = torch.autograd.grad((plain() * cot).sum(), (w, bias))
    for a, b, c in zip(got[0], got[1], want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-4)
