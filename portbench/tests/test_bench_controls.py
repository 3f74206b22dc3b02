"""The control, on the card: the reference computed in TF32 in the
program's place fails at least one number of each cell at the cell's
limits, at a size a test run holds."""

import pytest

from portbench import harness
from portbench.calibrate import reading
from portbench.cell import Context

SMALL = {
    "poisson2d-wide64.adam-b65536": dict(batch_size=8192),
    "poisson2d-readme.solve-b100": dict(niters=300, weights=4, judged=4),
    "poisson2d-wide64.predict-1m": dict(grid_side=256, judged=4),
    "poisson2d-wide64.lm-b65536": dict(batch_size=8192, adam_steps=500),
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_the_tf32_control_fails_a_limit(cell, seed, cuda_device):
    wl = harness.workload(cell)
    module = harness.traffic(wl["traffic"])
    ctx = Context(harness.config(wl["config"]),
                  dict(wl["params"], **SMALL[cell]), seed, cuda_device)
    seconds = 1.0 if wl["traffic"] in ("solve", "predict") else 0.0
    numbers = reading(module, ctx, seconds, control=True)
    assert any(v > wl["limits"][k] for k, v in numbers.items()), numbers
