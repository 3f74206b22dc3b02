"""Workload 2 — 2D Poisson equation (the README workload), on
pydens_tpu_torch:

    d2f/dx2 + d2f/dy2 = 5 * sin(pi * (x + y))  on [0,1]^2,  f = 1 on the
    boundary (bound exactly by the ansatz).

The port of examples/02.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/02_poisson_2d.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D


def pde(f, x, y):
    return D(D(f, x), x) + D(D(f, y), y) - 5 * torch.sin(np.pi * (x + y))


def cart_prod(*arrs):
    grids = np.meshgrid(*arrs, indexing="ij")
    return np.stack(grids, axis=-1).reshape(-1, len(arrs))


def main(device=None):
    solver = Solver(pde, ndims=2, boundary_condition=1,
                    layout="fa fa fa f", activation="Tanh",
                    units=[10, 12, 15, 1], seed=0, device=device)
    solver.fit(batch_size=100, niters=1500)

    grid = cart_prod(np.linspace(0, 1, 100), np.linspace(0, 1, 100))
    approx = solver.predict(grid[:, 0:1], grid[:, 1:2]).reshape(100, 100)
    print(f"final residual loss: {solver.losses[-1]:.6f}")
    print(f"solution range: [{approx.min():.3f}, {approx.max():.3f}]")
    edge = solver.predict(np.zeros(10), np.linspace(0, 1, 10)).ravel()
    edge_err = float(np.max(np.abs(edge - 1.0)))
    print(f"max boundary violation: {edge_err:.2e}")
    assert solver.losses[-1] < 0.01
    return solver, {"final_loss": float(solver.losses[-1]),
                    "edge_err": edge_err}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
