"""The plain reference against the port on the CPU, at a tiny size in
f32 (where the port runs its plain paths): every number the check
compares reads as rounding, through the harness's own run of each
cell."""

from __future__ import annotations

import pytest

from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_cell

# f32 on both sides, the same operations in another order at most
TOL = {"gated_rel": 1e-5, "rpn_rel": 1e-5, "prop_diff": 0.0,
       "head_rel": 1e-5, "sel_gap": 1e-5, "box_px": 0.0,
       "mask_err": 1e-5, "iu_diff": 0.0, "loss_gap": 1e-5,
       "grad_gap": 1e-4, "update_gap": 1e-4, "rpn_ce_gap": 1e-5}


@pytest.mark.parametrize("cell", ["response.serve.e16", "response.train.2x16",
                                  "cycle_response.train.2x16",
                                  "response.eval.mix4"])
def test_reference_agrees_with_the_port(cell):
    cfg, traffic = tiny_cell(cell)
    out = run_cell(cell, 987654321987, 1.0, False, device="cpu",
                   cfg_file=cfg, traffic=traffic)
    checks = {c["name"]: c["value"] for c in out["checks"]}
    for name, value in checks.items():
        assert value <= TOL[name], (cell, name, value)
