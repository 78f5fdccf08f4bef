"""Data-parallel training in the port (`lang2seg_tpu_torch/parallel/`), on
the CPU at the tiny `response` config: the loader's per-rank blocks
against the JAX loader's, per-example sampling draws (`expr_uid`), and
two gloo ranks (processes spawned with torch.multiprocessing, joined
through a file in the test's own directory) whose sharded step equals
the port's shardwise oracle bit for bit and matches the JAX per-shard
oracle with injected targets. `run_ranks` also runs the two-rank Trainer
(tests/test_torch_trainer.py) and eval_split_mesh
(tests/test_torch_eval_mesh.py): a rank imports the module of its
function."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lang2seg_tpu_torch.data.synthetic import synthetic_batch, to_wire
from lang2seg_tpu_torch.engine.train_state import (create_train_state,
                                                   stack_batches, to_device)
from lang2seg_tpu_torch.ops.targets import example_uniforms
from lang2seg_tpu_torch.parallel import (initialize_multihost, make_mesh,
                                         make_sharded_multi_step,
                                         make_sharded_train_step, shard_batch,
                                         sync_replicas)
from lang2seg_tpu_torch.parallel.train import (dropout_generator,
                                               sampling_generator,
                                               shardwise_step)
from tests.test_torch_weights import response_config, to_port_cfg

WORLD = 2


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- ranks


def _rank_entry(rank, world, root, job, fn):
    torch.set_num_threads(2)
    payload = torch.load(os.path.join(root, f"{job}_in.pt"),
                         weights_only=False)
    mesh = initialize_multihost(f"file://{root}/{job}_pg", world, rank,
                                device="cpu", timeout_s=300)
    try:
        out = fn(rank, mesh, **payload)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"{job}_out{rank}.pt"))


def run_ranks(fn, root, world=WORLD, **payload):
    """Run fn(rank, mesh, **payload) (a module-level function) on `world`
    gloo ranks, one process each; returns each rank's result."""
    root, job = str(root), fn.__name__
    torch.save(payload, os.path.join(root, f"{job}_in.pt"))
    mp.spawn(_rank_entry, args=(world, root, job, fn), nprocs=world,
             join=True)
    return [torch.load(os.path.join(root, f"{job}_out{r}.pt"),
                       weights_only=False) for r in range(world)]


def _momentum(state):
    opt = state.optimizer
    return [opt.state[p]["momentum_buffer"].clone()
            for g in opt.param_groups for p in g["params"]]


def _snapshot(state, losses, gens=()):
    return {"params": {k: v.clone() for k, v in
                       state.model.state_dict().items()},
            "momentum": _momentum(state), "step": state.step,
            "losses": losses, "gens": [g.get_state() for g in gens]}


def _sharded_job(rank, mesh, cfg, batches, steps_k, jax_cfg=None,
                 jax_batch=None, jax_targets=None, state_dict=None):
    """(a) one sharded step on block `rank` of batches[0], then one
    multi-step call of the rest (K = steps_k), expr_uid draws; (b) with
    `jax_cfg`, one sharded step with injected targets from `state_dict`."""
    state = create_train_state(cfg, device="cpu", seed=1)
    sync_replicas(state.model, mesh)
    gen = dropout_generator(cfg.seed, rank, "cpu")
    sgen = sampling_generator(cfg.seed, "cpu")
    step = make_sharded_train_step(state, mesh, gen, sgen)
    losses = [step(to_device(shard_batch(batches[0], WORLD, rank), "cpu"))]
    multi = make_sharded_multi_step(state, mesh, gen, sgen)
    blocks = [shard_batch(b, WORLD, rank) for b in batches[1:1 + steps_k]]
    losses.append(multi(to_device(stack_batches(blocks), "cpu")))
    out = {"a": _snapshot(state, losses, (gen, sgen))}
    if jax_cfg is not None:
        state = create_train_state(jax_cfg, device="cpu",
                                   state_dict=state_dict)
        sync_replicas(state.model, mesh)
        step = make_sharded_train_step(state, mesh, None, None)
        got = step(to_device(shard_batch(jax_batch, WORLD, rank), "cpu"),
                   jax_targets[rank])
        out["b"] = _snapshot(state, got)
    return out


# ---------------------------------------------------------------- oracle


def blocked_batch(cfg, blocks=WORLD, images=1, exprs=2, seed=0,
                  uid_base=0, wire=True):
    """`blocks` self-contained blocks (local img_idx) with stable uids,
    concatenated along axis 0, as get_batch(num_shards=n) gives them (in
    the config's wire formats with `wire`)."""
    parts = []
    for s in range(blocks):
        b = synthetic_batch(cfg, images, exprs, seed=seed * 17 + s)
        if wire:
            b = to_wire(cfg, b)
        b["expr_uid"] = (np.arange(exprs, dtype=np.int32) + s * exprs
                         + uid_base)
        parts.append(b)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _assert_same(got, want):
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    for a, b in zip(got["momentum"], want["momentum"]):
        assert torch.equal(a, b)
    assert got["step"] == want["step"]


# ---------------------------------------------------------------- tests


def test_loader_blocks_match_jax(tmp_path):
    """get_batch(num_shards=2) against the JAX loader's over an epoch's
    wrap, array for array (canvases to the resize tolerance), on the mini
    REFER tree of tests/test_torch_data.py; shard r gives block r of it,
    and every rank's loader stays in step."""
    from lang2seg_tpu.data.fixtures import make_mini_refer
    from lang2seg_tpu.data.prepro import run_prepro as jrun_prepro
    from lang2seg_tpu_torch.data.prepro import run_prepro
    from tests.test_torch_data import assert_batches_equal, loaders
    root = str(tmp_path)
    make_mini_refer(root, num_images=6, refs_per_image=3, sents_per_ref=3)
    tree = (root, jrun_prepro(root, "refcoco", "unc",
                              os.path.join(root, "prepro_jax"),
                              count_threshold=0),
            run_prepro(root, "refcoco", "unc", os.path.join(root, "prepro"),
                       count_threshold=0))
    jl, pl = loaders(tree)
    ranks = [loaders(tree)[1] for _ in range(WORLD)]
    for _ in range(3):
        want = jl.get_batch("train", num_shards=WORLD)
        got = pl.get_batch("train", num_shards=WORLD)
        assert_batches_equal(got, want)
        e = got["img_idx"].shape[0] // WORLD
        assert got["img_idx"].max() < got["images"].shape[0] // WORLD
        assert got["labels"].shape[0] == WORLD * e
        for r, loader in enumerate(ranks):
            block = loader.get_batch("train", num_shards=WORLD, shard=r)
            assert bool(block["wrapped"]) == bool(got["wrapped"])
            assert_batches_equal(
                {k: v for k, v in block.items() if k != "wrapped"},
                shard_batch({k: v for k, v in got.items() if k != "wrapped"},
                            WORLD, r), canvases=())
    for loader in ranks:
        assert loader.state_dict()["iterators"] == \
            pl.state_dict()["iterators"]


def test_example_uniforms_follow_the_uid():
    """An example's draws depend on the step key, its uid and the stream
    alone: the same at any position, different for another uid, stream
    or key, uniform on [0, 1) in 2**-24 steps."""
    key = torch.tensor([123456789, 987654321])
    uid = torch.tensor([5, 9, 5, 1 << 30], dtype=torch.int32)
    u = example_uniforms(key, uid, 0, 4096)
    assert u.dtype == torch.float32 and u.shape == (4, 4096)
    assert torch.equal(u[0], u[2])
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[3])
    moved = example_uniforms(key, uid.flip(0), 0, 4096)
    assert torch.equal(moved, u.flip(0))
    assert not torch.equal(example_uniforms(key, uid, 1, 4096), u)
    assert not torch.equal(example_uniforms(key + 1, uid, 0, 4096), u)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u * 2 ** 24, torch.round(u * 2 ** 24))
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert abs(float((u < 0.25).float().mean()) - 0.25) < 0.01


def test_subsample_follows_the_uid(monkeypatch):
    """train_forward with expr_uid: an example draws the same anchor and
    ROI subsample whichever position or block it lands in, other uids
    draw others; the draws come from one per-step key of the sampling
    generator."""
    import lang2seg_tpu_torch.models.network as network
    cfg = to_port_cfg(response_config())
    model = create_train_state(cfg, device="cpu", seed=1).model
    seen = []
    for name in ("anchor_targets", "proposal_targets"):
        real = getattr(network, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            out = _real(*a, **kw)
            seen.append((_name, kw["draws"], out.labels))
            return out
        monkeypatch.setattr(network, name, wrapped)
    batch = blocked_batch(cfg, blocks=2, images=1, exprs=2)
    perm = [3, 2, 1, 0]                     # block 1 first, reversed
    moved = {k: v[perm] for k, v in batch.items()
             if k not in ("images", "im_hw")}
    moved["images"] = batch["images"][::-1].copy()
    moved["im_hw"] = batch["im_hw"][::-1].copy()
    moved["img_idx"] = 1 - batch["img_idx"][perm]
    for b in (batch, moved):
        sg = torch.Generator().manual_seed(7)
        with torch.no_grad():
            model.train_forward(to_device(b, "cpu"), None,
                                torch.Generator().manual_seed(1), sg)
    (a0, da0, la0), (p0, dp0, _), (a1, da1, la1), (p1, dp1, _) = seen
    assert (a0, p0, a1, p1) == ("anchor_targets", "proposal_targets") * 2
    for d0, d1 in zip(da0 + dp0, da1 + dp1):
        assert torch.equal(d1, d0[perm])
        assert not torch.equal(d0[0], d0[1])
    assert torch.equal(la1, la0[perm])
    # the same uid twice in one batch draws twice the same
    twice = dict(batch, expr_uid=np.asarray([4, 4, 6, 7], np.int32))
    with torch.no_grad():
        model.train_forward(to_device(twice, "cpu"), None,
                            torch.Generator().manual_seed(1),
                            torch.Generator().manual_seed(7))
    assert torch.equal(seen[-2][1][0][0], seen[-2][1][0][1])


def test_shard_batch_checks_blocks():
    cfg = to_port_cfg(response_config())
    b = synthetic_batch(cfg, 2, 4, seed=0)
    b["img_idx"] = np.asarray([0, 1, 0, 1], np.int32)
    shard_batch(b, 1)
    with pytest.raises(ValueError, match="local"):
        shard_batch(b, 2)
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(b, 3)
    b["img_idx"] = np.asarray([0, 0, 0, 0], np.int32)
    block = shard_batch(b, 2, 1)
    assert block["labels"].shape[0] == 2 and block["images"].shape[0] == 1
    np.testing.assert_array_equal(block["gt_boxes"], b["gt_boxes"][2:])


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2)
    with pytest.raises(ValueError, match="world_size"):
        initialize_multihost("file:///nonexistent", device="cpu")


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The two gloo ranks' results: (a) 3 steps with expr_uid (one
    sharded step, then a K = 2 multi-step call), (b) one step with
    injected targets at LR 1 from shared weights, with the JAX oracle's
    inputs."""
    from tests.test_torch_train import _targets, train_config
    from tests.test_torch_weights import shared_weights
    cfg = to_port_cfg(response_config())
    batches = [blocked_batch(cfg, images=2, exprs=4, seed=s, uid_base=8 * s)
               for s in range(3)]
    jcfg = train_config(learning_rate=1.0)
    model, jmodel, params = shared_weights(jcfg, seed=4)
    # blocks of test_train_step_matches_jax_step's batch (2 images x 4
    # expressions, synthetic seed 5, targets seed 6) and the next seeds
    blocks = [synthetic_batch(to_port_cfg(jcfg), 2, 4, seed=5 + r)
              for r in range(WORLD)]
    jbatch = {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}
    targets = [_targets(jcfg, b, seed=6 + r) for r, b in enumerate(blocks)]
    root = tmp_path_factory.mktemp("sharded")
    outs = run_ranks(_sharded_job, root, cfg=cfg, batches=batches, steps_k=2,
                     jax_cfg=to_port_cfg(jcfg), jax_batch=jbatch,
                     jax_targets=targets, state_dict=model.state_dict())
    return cfg, batches, outs, (jcfg, model, jmodel, params, jbatch,
                                targets)


def test_sharded_steps_equal_the_shardwise_oracle(sharded_runs):
    """Both ranks end with the same weights, momentum and losses, equal
    bit for bit to the one-process oracle's three steps; each rank's
    dropout generator is its own, the sampling generator is shared."""
    cfg, batches, outs, _ = sharded_runs
    state = create_train_state(cfg, device="cpu", seed=1)
    gens = [dropout_generator(cfg.seed, r, "cpu") for r in range(WORLD)]
    sgen = sampling_generator(cfg.seed, "cpu")
    want = [shardwise_step(state, b, gens, sgen) for b in batches]
    for r, out in enumerate(outs):
        got = out["a"]
        _assert_same(got, _snapshot(state, None))
        first, multi = got["losses"]
        for k, v in want[0].items():
            assert torch.equal(first[k], v), k
            assert torch.equal(multi[k],
                               torch.stack([want[1][k], want[2][k]])), k
        assert torch.equal(got["gens"][0], gens[r].get_state())
        assert torch.equal(got["gens"][1], sgen.get_state())
    assert not torch.equal(outs[0]["a"]["gens"][0], outs[1]["a"]["gens"][0])


def test_sharded_step_matches_the_jax_oracle(sharded_runs):
    """With injected targets (word dropout off) at LR 1: the two ranks'
    update against JAX's per-shard oracle (tests/test_parallel.py): each
    block's JAX gradients, averaged, through the JAX optimizer chain.
    Every leaf within 1e-4 in relative L2 norm and the losses within 1e-4
    relative (test_torch_train.py::test_train_step_matches_jax_step, whose
    batch is block 0). The tolerance holds a block's gradients only where
    no ReLU input lies within f32 rounding of zero: at some other batches
    one kernel's gradient (layer2-4, mask_up) moves by 1.5e-4 to 2.6e-3
    between the frameworks, as tests/test_torch_mask_bias_grad.py shows."""
    import jax
    import jax.numpy as jnp
    import optax
    from lang2seg_tpu.engine.convert import convert_torch_state_dict
    from lang2seg_tpu.engine.optimizer import (build_optimizer,
                                               merge_params,
                                               partition_params)
    from tests.test_torch_train import _jax_loss_fn, _jax_targets
    from tests.test_torch_weights import _flat
    _, _, outs, (jcfg, model, jmodel, params, jbatch, targets) = sharded_runs
    trainable, frozen = partition_params(params, jcfg)
    grads = losses = None
    for r in range(WORLD):
        block = {k: jnp.asarray(v)
                 for k, v in shard_batch(jbatch, WORLD, r).items()}
        with jax.default_matmul_precision("float32"):
            (_, l), g = jax.value_and_grad(
                _jax_loss_fn(jmodel, block, _jax_targets(*targets[r])),
                has_aux=True)(params)
        grads = g if grads is None else jax.tree_util.tree_map(
            jnp.add, grads, g)
        losses = l if losses is None else jax.tree_util.tree_map(
            jnp.add, losses, l)
    grads = jax.tree_util.tree_map(lambda x: x / WORLD, grads)
    g_tr, _ = partition_params(grads, jcfg)
    tx = build_optimizer(trainable, jcfg)
    updates, _ = tx.update(g_tr, tx.init(trainable), trainable)
    want = _flat(merge_params(optax.apply_updates(trainable, updates),
                              frozen))
    old = _flat(params)
    assert torch.equal(outs[0]["b"]["params"]["rpn_net.weight"],
                       outs[1]["b"]["params"]["rpn_net.weight"])
    got = _flat(convert_torch_state_dict(
        {k: v.numpy() for k, v in outs[0]["b"]["params"].items()}, jcfg))
    total = float(outs[0]["b"]["losses"]["total_loss"])
    assert abs(total - float(losses["total_loss"]) / WORLD) <= \
        1e-4 * abs(float(losses["total_loss"]) / WORLD)
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
