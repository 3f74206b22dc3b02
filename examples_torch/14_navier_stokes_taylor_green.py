"""2D incompressible Navier-Stokes on pydens_tpu_torch: the decaying
Taylor-Green vortex.

Momentum + continuity train as a coupled 3-component system (u, v, p) on
the periodic unit square over t in [0, 1]:

    u_t + u u_x + v u_y + p_x = nu (u_xx + u_yy)
    v_t + u v_x + v v_y + p_y = nu (v_xx + v_yy)
    u_x + v_y = 0

Analytic solution (k = 2 pi, F(t) = exp(-2 k^2 nu t)):

    u = -cos(kx) sin(ky) F,   v = sin(kx) cos(ky) F,
    p = -(cos(2kx) + cos(2ky)) / 4 * F^2

Feature mix: the periodic Fourier input embedding on the spatial dims
(the fields and all their derivatives are exactly 1-periodic), the exact
vector initial condition at t = 0, a point constraint pinning the
pressure's spatial gauge, and the full second-order nonlinear system on
the Taylor plan (all derivative taps in one network traversal).

Route on the card: the embedded chain trains on the fused Taylor
kernels, from the embedding's Taylor state; ``predict`` runs the fused MLP
kernel after the embedding.  The port of examples/14.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/14_navier_stokes_taylor_green.py [--cpu]
"""

import sys

import numpy as np
import torch

import pydens_tpu_torch as pdt
from pydens_tpu_torch import Solver, D

NU = 0.02
K = 2 * np.pi
DECAY = 2 * K ** 2 * NU  # F(t) = exp(-DECAY * t)


def main(device=None):
    def ns(f, x, y, t):
        u, v, p = f[:, 0:1], f[:, 1:2], f[:, 2:3]

        def lap(w):
            return D(D(w, x), x) + D(D(w, y), y)

        return (
            D(u, t) + u * D(u, x) + v * D(u, y) + D(p, x) - NU * lap(u),
            D(v, t) + u * D(v, x) + v * D(v, y) + D(p, y) - NU * lap(v),
            D(u, x) + D(v, y),
        )

    def ic(x, y):
        return torch.stack(
            [-torch.cos(K * x) * torch.sin(K * y),
             torch.sin(K * x) * torch.cos(K * y),
             -0.25 * (torch.cos(2 * K * x) + torch.cos(2 * K * y))], dim=-1)

    # Pin the pressure gauge at (1/4, 1/4), where p_exact = F(t)^2 / 2.
    def gauge(f, x, y, t):
        return f(0.25, 0.25, t)[:, 2:3] - 0.5 * pdt.exp(-2 * DECAY * t)

    solver = Solver(ns, ndims=3, seed=0, periodic=(0, 1),
                    initial_condition=ic, constraints=gauge,
                    layout="fa fa fa f", features=[48, 48, 48, 3],
                    activation="Tanh", device=device)
    assert solver._plan_ok  # the whole system is Taylor-planned
    solver.fit(niters=1200, batch_size=1024, lr=2e-3,
               loss_terms={"equation": 1.0, "constraint_0": 10.0},
               progress=False)
    solver.fit(niters=400, batch_size=2048, lr=3e-4,
               loss_terms={"equation": 1.0, "constraint_0": 10.0},
               progress=False)

    g = np.linspace(0, 1, 33)[:-1]
    X, Y = [a.ravel() for a in np.meshgrid(g, g)]
    numbers = {}
    for t_eval in (0.5, 1.0):
        F = np.exp(-DECAY * t_eval)
        pred = solver.predict(np.stack(
            [X, Y, np.full_like(X, t_eval)], axis=-1))
        u_err = float(np.max(np.abs(
            pred[:, 0] + np.cos(K * X) * np.sin(K * Y) * F)))
        v_err = float(np.max(np.abs(
            pred[:, 1] - np.sin(K * X) * np.cos(K * Y) * F)))
        p_err = float(np.max(np.abs(
            pred[:, 2] + 0.25 * (np.cos(2 * K * X) + np.cos(2 * K * Y))
            * F ** 2)))
        print(f"t={t_eval}: max err u {u_err:.4f}  v {v_err:.4f}  "
              f"p {p_err:.4f}")
        numbers[f"t={t_eval}"] = [u_err, v_err, p_err]
        assert u_err < 0.03 and v_err < 0.03 and p_err < 0.05
    return solver, numbers


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
