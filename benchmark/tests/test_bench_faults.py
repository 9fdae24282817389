"""A run of each cell on the CPU at a small size, the look for a card
skipped, with the timed path broken underneath (its driver's ``FAULTS``,
planted by ``faults.py``): ``correct`` has to come out false, once for
each fault the cell can have (one card: no exchange between chips to
leave out).  And the same run unbroken comes out true."""

import json

import pytest
import torch

import run
from faults import driver_faults, plant
from harness import manifest as mf

M = mf.load_manifest()
DRIVERS = {w["name"]: mf.load_json("traffic", w["traffic"])["driver"] for w in M["workloads"]}
# every cell of the manifest, unbroken and under each fault of its driver
CASES = [(cell, d, f) for cell, d in DRIVERS.items() for f in ["none", *driver_faults(d)]]


@pytest.mark.parametrize("cell,driver,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, driver, fault, small, capsys):
    torch.manual_seed(0)
    restore = plant(driver, fault) if fault != "none" else (lambda: None)
    try:
        rc = run.run_cell(cell, 2**31 + 12345, 3.0, False, device="cpu", overrides=small[cell])
    finally:
        restore()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    checks = out["checks"]
    assert rc == 0
    assert out["correct"] is (fault == "none"), checks
    if fault == "state_unchanged" and "first_chunk_change_gap" in checks:
        # judged by the comparison itself, not by a missing first solve
        assert checks["judged_problems"]["value"] >= checks["judged_problems"]["limit"]
        assert checks["first_chunk_change_gap"]["value"] == pytest.approx(1.0)
    if fault == "map_moved":
        assert checks["start_map_gap"]["value"] > checks["start_map_gap"]["limit"]
