"""Workload 1 — simple ODE with an initial condition, on pydens_tpu_torch:

    f'(x) = 2*pi*cos(2*pi*x),  f(0) = 0.5  on [0, 1].

Analytic solution: f(x) = sin(2*pi*x) + 0.5.  The port of examples/01;
each training step runs the fused Taylor forward and backward kernels on
the card, ``predict`` the fused MLP kernel.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/01_simple_ode.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D


def ode(f, x):
    return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)


def main(device=None):
    solver = Solver(ode, ndims=1, initial_condition=.5, activation="Tanh",
                    layout="fafaf", features=[12, 10, 1], seed=0,
                    device=device)
    solver.fit(niters=500, batch_size=400, lr=0.02)

    xs = np.linspace(0, 1, 100)
    approx = solver.predict(xs).ravel()
    true = np.sin(2 * np.pi * xs) + .5
    err = float(np.max(np.abs(approx - true)))
    print(f"final residual loss: {solver.losses[-1]:.6f}")
    print(f"max |approx - analytic|: {err:.4f}")
    assert err < 0.05
    return solver, {"err": err, "final_loss": float(solver.losses[-1])}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
