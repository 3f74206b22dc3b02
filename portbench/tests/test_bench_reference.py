"""The plain reference against ``pydens_tpu_torch`` at a small size on the
CPU: loss, gradient, three Adam steps, an LM step and predict.  (This test
imports the program; the reference itself never does.)"""

import numpy as np
import pytest
import torch

from portbench import compare, harness, inputs, program
from portbench.reference import pinn

CPU = torch.device("cpu")


@pytest.fixture(params=["poisson2d-readme", "poisson2d-wide64"])
def case(request, one_thread):
    cfg = harness.config(request.param)
    solver = program.solver(cfg, CPU, 2 ** 40 + 9)
    theta = inputs.weights(cfg, 3, inputs.WEIGHTS, 1, CPU)[0]
    program.load(solver, cfg, theta)
    return cfg, solver, theta


def test_weights_load_in_the_reference_order(case):
    cfg, solver, theta = case
    assert torch.equal(program.flat_params(solver, cfg), theta)
    bounds = pinn.init_bounds(cfg, CPU)
    assert bool((theta.abs() <= bounds).all()) and theta[0] == 0


def test_loss_gradient_and_adam_match_the_program(case):
    cfg, solver, theta = case
    draws = program.Draws(solver).take(2)
    solver.fit(niters=1, batch_size=64, progress=False)
    mu = program.optimizer_state(solver)["mu"]
    solver.fit(niters=2, batch_size=64, optimizer=None, progress=False)
    batches = draws.batches()
    assert len(batches) == 3 and batches[0].shape == (64, 2)
    losses, grad, theta3 = pinn.adam_steps(cfg, theta, batches, 0.005)
    np.testing.assert_allclose(solver.losses, losses, rtol=2e-5)
    np.testing.assert_allclose(mu / (1 - pinn.ADAM_B1), grad.numpy(),
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(program.flat_params(solver, cfg).numpy(),
                               theta3.numpy(), rtol=1e-4, atol=1e-6)
    assert float(grad.abs().max()) > 0


def test_one_lm_step_matches_the_program(case):
    """From 100 Adam steps on, where the first LM step is accepted, as in
    the LM cell after its Adam stage."""
    cfg, solver, theta = case
    gen = torch.Generator().manual_seed(5)
    _, _, theta = pinn.adam_steps(
        cfg, theta, [torch.rand(64, 2, generator=gen) for _ in range(100)],
        0.005)
    program.load(solver, cfg, theta)
    draws = program.Draws(solver).take(1)
    with program.first_linearization() as seen:
        solver.fit(niters=1, batch_size=64, optimizer="LM", cg_iters=3,
                   resample=False, progress=False)
    pts, = draws.batches()
    value, jtr, theta1, _, live = pinn.lm_step(cfg, theta, pts, (1e-3, 2.0),
                                               3)
    assert live == 3 and float((theta - theta1).abs().max()) > 0
    np.testing.assert_allclose(solver.losses[0], value, rtol=1e-5)
    np.testing.assert_allclose(program.flat_params(solver, cfg).numpy(),
                               theta1.numpy(), rtol=2e-3, atol=2e-5)
    # The first step's products, in the reference's layout.
    ref = pinn.lm_products(cfg, theta, pts, seen["v"], seen["w"])
    np.testing.assert_allclose(seen["jtr"].numpy(), jtr.numpy(), rtol=1e-4,
                               atol=1e-7)
    for key, r in zip(("jtr", "jv", "jtw"), ref):
        assert compare.relative_gap(seen[key], r) < 1e-5, key


def test_predict_matches_the_program(case):
    cfg, solver, theta = case
    grid, = inputs.grids(4, 1, 16, 2)
    u = solver.predict(grid)
    ref = pinn.predict(cfg, theta, torch.as_tensor(grid), block=100)
    np.testing.assert_allclose(u, ref.numpy(), rtol=1e-6, atol=1e-6)
    edge = solver.predict(np.zeros((5, 1), np.float32),
                          np.linspace(0, 1, 5, dtype=np.float32)[:, None])
    np.testing.assert_allclose(edge, 1.0)
