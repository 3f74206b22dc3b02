"""A run with the chip's look skipped, on the CPU at a small size: sound,
it comes out correct; with each fault its traffic kind can have planted
in the timed path (``portbench/faults.py``), it comes out not correct."""

import time

import pytest
import torch

from portbench import faults, harness

SMALL = {
    "poisson2d-wide64.adam-b65536": dict(batch_size=256, chunk_size=4),
    "poisson2d-readme.solve-b100": dict(niters=12, weights=3, judged=3),
    "poisson2d-wide64.predict-1m": dict(grid_side=32),
    "poisson2d-wide64.lm-b65536": dict(batch_size=128, adam_steps=12,
                                       chunk_size=3, cg_iters=4,
                                       steps_per_fit=2),
}
CASES = [(cell, fault) for cell in SMALL
         for fault in (None,) + harness.traffic(
             harness.workload(cell)["traffic"]).FAULTS]


def run(cell):
    return harness.run_cell(cell, 2 ** 31 + 77, 0.3, False,
                            torch.device("cpu"), time.perf_counter(),
                            overrides=SMALL[cell])


@pytest.mark.parametrize("cell,fault", CASES)
def test_each_fault_makes_the_run_not_correct(cell, fault, one_thread):
    if fault is None:
        result = run(cell)
        assert result["correct"], result["checks"]
    else:
        with faults.planted(fault):
            result = run(cell)
        assert not result["correct"], (fault, result["checks"])
    assert list(result)[-1] == "checks" and result["attempted"] > 0


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_run_is_correct_and_reports_its_metrics(cell, one_thread):
    """The ``--trace 1`` path on the CPU: the untraced timing, the profiled
    window, the check, and per-layer metrics of the cell's own only (no
    device operation runs here, so the device readers find nothing)."""
    result = harness.run_cell(cell, 2 ** 31 + 78, 0.3, True,
                              torch.device("cpu"), time.perf_counter(),
                              overrides=SMALL[cell])
    assert result["correct"], result["checks"]
    names = {m["name"] for m in harness.metrics_of(
        harness.manifest(), cell, "per_layer")}
    assert result["metrics"] and set(result["metrics"]) <= names
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    assert list(result)[-1] == "checks"


def test_a_solve_that_misses_the_readme_check_is_not_failed(one_thread):
    """Twelve steps leave every solve above the README's loss of 0.01: a
    sound answer to a harder start, so ``failed`` stays 0 (the sets of
    runs of one code agree on it) and ``solve_s`` counts none of them."""
    cell = "poisson2d-readme.solve-b100"
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"]["solve_s"]["value"] >= 0.3
