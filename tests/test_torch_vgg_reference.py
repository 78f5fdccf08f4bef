"""The `vgg` configuration of the benchmark (VGG16 Faster R-CNN, the
reference's detection-only network) held against its plain reference,
`benchmark/reference/vgg.py`, on the CPU at the tiny size of
`benchmark/tests/tiny.py` (128 x 192 canvas, f32, 4 expressions of 32
ROIs; VGG16 keeps its depth and widths).

The cell `vgg.train.2x16` runs through the harness as on the card: the
program's Trainer takes its steps on seeded random weights, and the
reference's three SGD steps judge them (`benchmark/check.py::
train_numbers`) against the cell's limits. A run with the `frozen` fault
planted is not correct. The reference's parts are checked against the
program's: the state-dict keys and shapes, the frozen layers, and the
fc6 / fc7 tail with its channel-major flatten and its dropout draws. The
bound of the fc stack (`benchmark/bounds/dense.py`) counts what
`FlopCounterMode` counts of the program's `fc_stack`.

fc6 alone is 411 MB in f32, so the file runs the cell twice and shares
the rest: two torch threads, one traced run for every check of it."""

from __future__ import annotations

import ast
import contextlib
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import faults, flops, harness
from benchmark.bounds import dense
from benchmark.bounds.peaks import F32_FLOPS
from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_cell
from benchmark.trace import TraceSummary
from lang2seg_tpu_torch.models import vgg as pvgg
from lang2seg_tpu_torch.models.network import Lang2Seg
from lang2seg_tpu_torch.utils import trace

CELL = "vgg.train.2x16"
SEED = 2 ** 33 + 2024
ROOT = harness.ROOT
GAPS = ("loss_gap", "rpn_ce_gap", "grad_gap", "update_gap")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs its files in parallel worker processes; torch's
    default of one thread a core in each oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny():
    cfg, traffic = tiny_cell(CELL)
    traffic["chunk_steps"] = 1
    return cfg, traffic


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One traced run of the cell at its tiny size: the result, its
    standard error and the change of the program's counters."""
    cfg, traffic = _tiny()
    err = io.StringIO()
    before = trace.counters().get("vgg.fc_rows", 0)
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stderr(err):
        mp.setattr(flops, "CACHE", tmp_path_factory.mktemp("flops"))
        out = run_cell(CELL, SEED, 0.5, True, device="cpu", cfg_file=cfg,
                       traffic=traffic)
    rows = trace.counters().get("vgg.fc_rows", 0) - before
    return cfg, traffic, out, err.getvalue(), rows


def test_the_cell_is_correct(traced):
    _, _, out, _, _ = traced
    assert out["result"]["correct"] is True, out["result"]["checks"]
    assert out["result"]["attempted"] >= 1


@pytest.mark.parametrize("name", GAPS)
def test_each_gap_lies_inside_the_cells_limit(traced, name):
    """The three Trainer steps' losses, the first gradients and the
    parameters' change against the reference's, by the cell's limits."""
    _, _, out, _, _ = traced
    limit = harness.limits_file(CELL)["limits"][name]
    assert 0.0 <= out["numbers"][name] <= limit


def test_the_proposals_are_the_references_bit_for_bit(traced):
    """At each checked step, the reference's proposal layer on the
    program's RPN outputs keeps the program's proposals."""
    _, _, out, _, _ = traced
    assert out["numbers"]["prop_diff"] == 0.0


def test_the_fc_stack_is_timed_and_counted(traced):
    """The traced run wraps the program's `fc_stack` once a step it took
    in the window, `vgg.fc_rows` counts every ROI of every step, and the
    metric's reader turns the op's bound over its device time into a
    share (the CPU's trace holds no device time, so the run's line has
    no such share)."""
    _, traffic, out, err, rows = traced
    calls = re.search(r"trace: op calls (\{[^}]*\})", err)
    assert calls, err
    steps = out["result"]["attempted"]
    assert ast.literal_eval(calls.group(1))["vgg_fc"] == steps
    per_step = traffic["expressions"] * traced[0]["config"]["train"][
        "roi_batch_size"]
    assert rows == per_step * (traffic["checked_steps"] + steps)
    assert "vgg_fc_roofline_pct.train" not in out["result"]["metrics"]
    layers = ((per_step, 25088, 4096), (per_step, 4096, 4096))
    bound = dense.bound_s(layers)
    reader = harness.metric_reader("vgg_fc_roofline_pct.train")
    view = {"summary": TraceSummary(1.0, 1.0, {"vgg_fc": 2 * bound}),
            "bounds": {"vgg_fc": bound}}
    assert reader.read(view) == pytest.approx(50.0)
    assert reader.read({"summary": TraceSummary(1.0, 1.0),
                        "bounds": {}}) is None


def test_a_frozen_step_is_not_correct():
    cfg, traffic = _tiny()
    undo = faults.plant("frozen")
    try:
        out = run_cell(CELL, SEED + 1, 0.2, False, device="cpu",
                       cfg_file=cfg, traffic=traffic)
    finally:
        undo()
    assert out["result"]["correct"] is False, out["result"]["checks"]


def test_the_reference_holds_the_programs_state_and_frozen_layers():
    """Every key and shape of the program's `vgg` network, at published
    widths, and the same trainable set: conv1_* and conv2_* frozen."""
    cfg_file = harness.config_file(harness.manifest(), "vgg")
    ref = harness.reference_of(cfg_file)
    assert Path(ref.__file__).name == "vgg.py"
    with torch.device("meta"):
        net = ref.Reference(cfg_file["config"])
        prog = Lang2Seg(harness.program_config(cfg_file["config"], 0))
    net.set_frozen()
    mine = net.reference_state_keys()
    theirs = dict(prog.named_parameters())
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in prog.state_dict().items()}
    assert {k for k, p in mine.items() if not p.requires_grad} == \
        {k for k, p in theirs.items() if not p.requires_grad} == \
        {f"vgg.features.{i}.{w}" for i in (0, 2, 5, 7)
         for w in ("weight", "bias")}
    with pytest.raises(NotImplementedError, match="detection-only"):
        net.mask_probs(None, None, None)


@pytest.mark.parametrize("train", [False, True])
def test_the_references_tail_is_the_programs(train):
    """The reference's fc6 / fc7 tail on the program's weights (shared,
    not copied): the channel-major flatten, and in train mode fc6's
    dropout mask, then fc7's, drawn from the generator as the program
    draws them, bit for bit."""
    ref = harness.reference_of(harness.config_file(harness.manifest(),
                                                   "vgg"))
    prog = pvgg.VGG16(torch.float32)
    with torch.device("meta"):
        mine = ref.VGG16(prog.drop_rate)
    mine.classifier.load_state_dict(prog.classifier.state_dict(),
                                    assign=True)
    prog.train(train)
    mine.train(train)
    crops = torch.from_numpy(np.random.RandomState(5).randn(
        6, 7, 7, 512).astype(np.float32))
    gens = [torch.Generator().manual_seed(9) for _ in range(2)]
    with torch.no_grad():
        want = prog.tail(crops, gens[0])
        got = mine.tail(crops, gens[1])
    assert got.shape == want.shape == (6, 1, 1, 4096)
    assert torch.equal(got, want)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    fresh = torch.Generator().manual_seed(9).get_state()
    assert torch.equal(gens[0].get_state(), fresh) is not train


def test_the_dense_bound_counts_the_fc_stacks_products():
    """`bounds/dense.py`'s operations, from what the op keeps of a call,
    are `FlopCounterMode`'s count of the program's `fc_stack` at the
    cell's 4,096 rows (on the meta device)."""
    op = harness.op_files()["vgg_fc"]
    assert op.ENTRY == ("lang2seg_tpu_torch.models.vgg", "fc_stack")
    with torch.device("meta"):
        tail = pvgg.VGG16(torch.float32)
        flat = torch.empty((4096, 25088))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        out = pvgg.fc_stack(flat, tail.classifier, 0.0, None)
    layers = op.keep((flat, tail.classifier, 0.0, None), {}, out)
    assert layers == ((4096, 25088, 4096), (4096, 4096, 4096))
    assert dense.flops(layers) == fc.get_total_flops() == \
        2 * 4096 * (25088 + 4096) * 4096
    assert op.bound_s(layers) == dense.flops(layers) / F32_FLOPS


def test_the_reference_imports_nothing_of_the_program_or_of_jax():
    """Plain torch and `model.py`'s plain parts only."""
    path = ROOT / "benchmark" / "reference" / "vgg.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            else:
                assert node.module in (None, "model"), node.module
    assert names <= {"__future__", "typing", "torch"}, names
