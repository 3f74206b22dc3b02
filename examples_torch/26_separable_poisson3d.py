"""Separable PINN (SPINN-style) on a 3D Poisson problem, on
pydens_tpu_torch.

    -Δu = 3 π² sin(πx) sin(πy) sin(πz)  on (0,1)³,  u = 0 on the boundary
    ⇒ u = sin(πx) sin(πy) sin(πz)

``SeparableModel`` factorizes the solution as ``u(x,y,z) = Σ_r
h_x(x)[r] · h_y(y)[r] · h_z(z)[r]`` with one small MLP per axis, so a 32³
= 32 768-point grid per iteration costs three 32-row MLP evaluations plus
contractions.  Derivatives come through the same ``D`` token.  Dense
evaluation is factorized too: ``predict_grid`` returns the full 65³
verification grid from three axis evaluations.

Route on the card: no fused kernel — the grid's derivative taps run in
forward mode on jets (``SeparableModel.grid_taps``), the contractions as
einsums.  The port of examples/26.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/26_separable_poisson3d.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D, SeparableModel


def make_solver(device=None):
    def poisson(f, x, y, z):
        return (D(D(f, x), x) + D(D(f, y), y) + D(D(f, z), z)
                + 3 * np.pi ** 2 * torch.sin(np.pi * x)
                * torch.sin(np.pi * y) * torch.sin(np.pi * z))

    return Solver(poisson, ndims=3, boundary_condition=0.0,
                  model=SeparableModel, layout="fa fa f",
                  features=[32, 32, 32], activation="Tanh", seed=0,
                  device=device)


def main(niters=500, device=None):
    solver = make_solver(device)
    # batch_size is points PER AXIS: 32**3 = 32768 grid points/iteration.
    solver.fit(niters=niters, batch_size=32, lr=2e-3, progress=False)

    g = np.linspace(0, 1, 65)
    pred = solver.predict_grid(g, g, g)[..., 0]  # 65^3 grid, 3 axis evals
    s = np.sin(np.pi * g)
    true = s[:, None, None] * s[None, :, None] * s[None, None, :]
    rel = float(np.linalg.norm(pred - true) / np.linalg.norm(true))
    print(f"separable 3d poisson rel_l2 = {rel:.5f} "
          f"({niters} iters x 32^3 grid points)")
    assert rel < 0.02, rel
    return solver, {"rel_l2": rel}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
