"""Evaluation over several ranks (`Evaluator.eval_split_mesh`, the JAX
package's device-parallel eval), on the CPU at the tiny `response` config
over the mini split of tests/test_torch_eval_modes.py (9 images in
buckets 4 and 8, two of them beyond 160 x 160 paste buffers): two gloo
ranks (tests/test_torch_parallel.py::run_ranks) give every rank exactly
`eval_split`'s accumulator, at one and two images a dispatch, and agree
with the JAX `eval_split_mesh` on 2 virtual devices (JAX
tests/test_eval_mesh.py holds it to `eval_split` at abs 1e-12)."""

import copy

import numpy as np
import pytest
import torch

from lang2seg_tpu_torch.engine.evaluator import Evaluator
from lang2seg_tpu_torch.models.network import build_model
from lang2seg_tpu_torch.utils.metrics import SegEvalAccumulator
from tests.test_torch_eval_modes import _close, _state, setup  # noqa: F401
from tests.test_torch_parallel import run_ranks
from tests.test_torch_weights import to_port_cfg


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mesh_eval(rank, mesh, cfg, state_dict, batches, modes):
    """Each mode's accumulator state on this rank, with the images this
    rank scored."""
    model = build_model(cfg, device="cpu", state_dict=state_dict)
    out = {}
    for k, paste in modes:
        c = copy.deepcopy(cfg)
        if paste:
            c.data.max_orig_h = c.data.max_orig_w = paste
        ev = Evaluator(model, c, device="cpu")
        seen = []
        real = ev.dispatch_image

        def dispatched(batch, sent_valid=None, uid=None):
            seen.append(uid)
            return real(batch, sent_valid, uid)
        ev.dispatch_image = dispatched
        real_stack = ev._stack_chunk

        def stacked(chunk, uids):
            seen.extend(uids)
            return real_stack(chunk, uids)
        ev._stack_chunk = stacked
        acc = SegEvalAccumulator()
        summary = ev.eval_split_mesh(batches, mesh, images_per_dispatch=k,
                                     acc=acc)
        out[(k, paste)] = (_state(acc), summary, sorted(set(seen)))
    return out


MODES = ((1, None), (2, None), (2, 160))


@pytest.fixture(scope="module")
def mesh_runs(setup, tmp_path_factory):  # noqa: F811
    cfg, model = setup[:2]
    batches = setup[4][True]
    return run_ranks(_mesh_eval, tmp_path_factory.mktemp("eval_mesh"),
                     cfg=to_port_cfg(cfg), state_dict=model.state_dict(),
                     batches=batches, modes=MODES)


def test_mesh_eval_equals_eval_split(setup, mesh_runs):  # noqa: F811
    """Every rank's accumulator equals one process's eval_split exactly,
    in each mode: one image a dispatch, two (chunks of a bucket's images
    on each rank), and two with 160 x 160 paste buffers (the 150 x 200
    and 200 x 150 images pasted on the host). Rank r scored images r, r +
    2, ... of each bucket, with the uids eval_split gives them."""
    cfg, model = setup[:2]
    batches = setup[4][True]
    buckets = {}
    for i, b in enumerate(batches):
        buckets.setdefault(b["labels"].shape[0], []).append(i + 1)
    for k, paste in MODES:
        pcfg = to_port_cfg(cfg)
        if paste:
            pcfg.data.max_orig_h = pcfg.data.max_orig_w = paste
        acc = SegEvalAccumulator()
        want = Evaluator(model, pcfg, device="cpu").eval_split(
            batches, images_per_dispatch=k, acc=acc)
        for r, out in enumerate(mesh_runs):
            state, summary, seen = out[(k, paste)]
            assert state == _state(acc), (k, paste, r)
            assert summary == want
            assert seen == sorted(u for us in buckets.values()
                                  for u in us[r::2])


def test_mesh_eval_matches_jax_mesh_eval(setup, mesh_runs,  # noqa: F811
                                         monkeypatch):
    """The ranks' accumulator against the JAX Evaluator's eval_split_mesh
    on 2 virtual devices (tests/test_torch_eval_modes.py's tolerances:
    the same detections and Prec@X, I and U within 4 pixels an image)."""
    import jax
    import lang2seg_tpu.engine.evaluator as jax_evaluator
    from lang2seg_tpu.engine.evaluator import Evaluator as JaxEvaluator
    from lang2seg_tpu.parallel.mesh import make_mesh
    from lang2seg_tpu.utils.metrics import SegEvalAccumulator as JaxAcc
    cfg, _, jmodel, params, batches = setup
    made = []

    class Recorded(JaxAcc):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(jax_evaluator, "SegEvalAccumulator", Recorded)
    with jax.default_matmul_precision("float32"):
        JaxEvaluator(jmodel, cfg).eval_split_mesh(
            params, [dict(b) for b in batches[True]], make_mesh(2))
    jacc = made[-1]
    got = SegEvalAccumulator()
    (got.num_sent, got.det_correct, got.cum_i, got.cum_u, seg,
     got.seg_total) = mesh_runs[0][(1, None)][0]
    got.seg_correct = np.asarray(seg)
    _close(got, jacc, len(batches[True]))
