"""(2+1)-dimensional wave equation with a separable PINN, on
pydens_tpu_torch.

    u_tt = u_xx + u_yy on (0,1)², t ∈ (0,1),  u|∂Ω = 0,
    u(x,y,0) = sin(πx) sin(πy),  u_t(x,y,0) = 0
    ⇒ u = sin(πx) sin(πy) cos(√2 πt)

Every iteration trains the FULL 32³ space-time grid (32 768 collocation
points for three 32-row MLP evaluations), so the oscillation is always
densely sampled, and both initial conditions bind exactly through the
squared time-gate (``initial_condition_t``).  See examples_torch/26 for
the separable mechanics.

Route on the card: no fused kernel — the grid's taps on jets, the
contractions as einsums.  The port of examples/27.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/27_separable_wave2d.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D, SeparableModel


def main(niters=700, device=None):
    def wave(f, x, y, t):
        return D(D(f, t), t) - D(D(f, x), x) - D(D(f, y), y)

    solver = Solver(
        wave, ndims=3, boundary_condition=0.0,
        initial_condition=lambda x, y: torch.sin(np.pi * x)
        * torch.sin(np.pi * y),
        initial_condition_t=0.0, model=SeparableModel,
        layout="fa fa f", features=[32, 32, 32], activation="Tanh", seed=0,
        device=device)
    solver.fit(niters=niters, batch_size=32, lr=2e-3, progress=False)

    g = np.linspace(0, 1, 21)
    pred = solver.predict_grid(g, g, g)[..., 0]
    X, Y, T = np.meshgrid(g, g, g, indexing="ij")
    true = (np.sin(np.pi * X) * np.sin(np.pi * Y)
            * np.cos(np.sqrt(2) * np.pi * T))
    rel = float(np.linalg.norm(pred - true) / np.linalg.norm(true))
    print(f"separable 2+1d wave rel_l2 = {rel:.5f} ({niters} iters)")
    assert rel < 0.05, rel
    return solver, {"rel_l2": rel}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
