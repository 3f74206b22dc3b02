"""Allen-Cahn, the standard hard PINN benchmark, on pydens_tpu_torch.

    u_t = 1e-4 u_xx + 5 (u - u^3),   x in [-1, 1) periodic,   t in [0, 1],
    u(x, 0) = x^2 cos(pi x)

Stiff bistable reaction: sharp transition layers form from a smooth IC
and then propagate — plain PINN training famously collapses to the
trivial metastable branch.  The recipe:

* ``periodic={0: 10}``: multi-harmonic exact-periodic embedding;
* persistent exact-IC binding (the default); ``periodic_ic_decay=False``
  acknowledges the advisory warning about the wrap-incompatible IC slope;
* ``fit(causal=eps)`` annealed 1 -> 5 -> 20: time-ordered residual
  weighting, eps a runtime scalar, so the staged schedule replays ONE
  captured step.

Ground truth: 512-mode Fourier spectral RK4.  The embedded chain trains
on the fused Taylor kernels, from the embedding's Taylor state;
``predict`` runs the fused MLP kernel after the embedding.  The port of examples/25 (the separable recipe,
examples/28, does better where a tensor-product grid applies).

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/25_allen_cahn.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D


def spectral_truth(nx=512, nt=2001, t_eval=0.25):
    """Fourier spectral RK4 reference solution at t_eval."""
    x = np.linspace(-1, 1, nx, endpoint=False)
    k = np.fft.fftfreq(nx, d=2.0 / nx) * 2 * np.pi
    u = (x ** 2) * np.cos(np.pi * x)
    dt = 1.0 / (nt - 1)

    def rhs(u):
        return (1e-4 * np.real(np.fft.ifft(-(k ** 2) * np.fft.fft(u)))
                + 5 * (u - u ** 3))

    target = None
    for i in range(nt - 1):
        k1 = rhs(u)
        k2 = rhs(u + dt / 2 * k1)
        k3 = rhs(u + dt / 2 * k2)
        k4 = rhs(u + dt * k3)
        u = u + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        if abs((i + 1) * dt - t_eval) < dt / 2:
            target = u.copy()
    return x, target


def main(iters_per_stage=4000, device=None):
    def allen_cahn(f, x, t):
        return D(f, t) - 1e-4 * D(D(f, x), x) - 5.0 * (f - f ** 3)

    solver = Solver(allen_cahn, ndims=2, seed=0, domain=[(-1, 1), (0, 1)],
                    initial_condition=lambda x: x ** 2 * torch.cos(np.pi * x),
                    periodic={0: 10}, periodic_ic_decay=False,
                    activation="Tanh", layout="fa fa fa fa f",
                    features=[64, 64, 64, 64, 1], device=device)
    for eps in (1.0, 5.0, 20.0):  # one captured step: eps is a buffer
        solver.fit(niters=iters_per_stage, batch_size=1024, lr=1e-3,
                   causal=eps, chunk_size=iters_per_stage, progress=False)

    x_ref, u_true = spectral_truth(t_eval=0.25)
    pred = solver.predict(x_ref, np.full_like(x_ref, 0.25)).ravel()
    rel = float(np.linalg.norm(pred - u_true) / np.linalg.norm(u_true))
    print(f"allen-cahn rel_l2(t=0.25) = {rel:.4f}")
    assert rel < 0.45, rel
    return solver, {"rel_l2": rel}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
