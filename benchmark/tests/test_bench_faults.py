"""A run with its timed path broken underneath comes out not correct:
the harness's whole run on the CPU at a tiny size (skipping only its look
for a card), with each fault the cell can have planted in the program."""

from __future__ import annotations

import pytest

from benchmark import faults
from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_cell

CASES = [("response.train.2x16", "frozen"), ("response.train.2x16", "half"),
         ("cycle_response.train.2x16", "frozen"),
         ("cycle_response.train.2x16", "half"),
         ("response.serve.e16", "answer"), ("response.eval.mix4", "answer")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    cfg, traffic = tiny_cell(cell)
    undo = faults.plant(fault)
    try:
        out = run_cell(cell, 424242424242, 1.0, False, device="cpu",
                       cfg_file=cfg, traffic=traffic)
    finally:
        undo()
    assert out["result"]["correct"] is False, out["result"]["checks"]
