"""The control comes out not correct: the reference in fp8 (the
precision below the configuration's bf16) in the program's place, at
each cell's own size, judged by the run's comparison against the cell's
limits. Needs a CUDA device (`cuda` marker; skips without one)."""

from __future__ import annotations

import pytest
import torch

from benchmark import check as chk
from benchmark import harness
from benchmark.run import Context

CELLS = ["response.serve.e16", "response.train.2x16",
         "cycle_response.train.2x16", "response.eval.mix4"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cells' "
                    "own size")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    man = harness.manifest()
    w = harness.cell(man, cell)
    ctx = Context(harness.config_file(man, w["config"]),
                  harness.traffic_file(w["traffic"]), 31337, 20.0, card)
    drv = harness.driver(ctx.traffic["entry"]).Driver(ctx)
    drv.setup(program=False)
    numbers = drv.check(drv.control())
    checks = chk.with_limits(numbers, harness.limits_file(cell)["limits"])
    assert not harness.checks_ok(checks), checks
