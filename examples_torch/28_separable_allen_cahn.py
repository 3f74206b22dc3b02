"""Allen-Cahn with a separable PINN, on pydens_tpu_torch.

    u_t = 1e-4 u_xx + 5 (u - u³),  x ∈ [-1, 1) periodic,  t ∈ [0, 1],
    u(x, 0) = x² cos(πx)

Every iteration trains a dense 64×64 tensor grid (4096 points at two
64-row MLP evaluations), and causal weighting uses exact per-time-slice
mean residuals.  Same ingredients as examples_torch/25 otherwise:
`periodic={0: 10}` multi-harmonic embedding (per axis,
separability-preserving), persistent exact-IC binding
(`periodic_ic_decay=False` acknowledges the wrap-kink advisory),
`causal=eps` annealed 1 → 5 → 20 on one captured step (eps is a buffer).

Route on the card: no fused kernel — the grid's taps on jets, the
contractions as einsums; one CUDA graph for the three stages.  The port
of examples/28.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/28_separable_allen_cahn.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D, SeparableModel


def spectral_truth(nx=512, nt=2001, t_evals=(0.25, 0.5, 1.0)):
    """512-mode Fourier spectral RK4 ground truth."""
    x = np.linspace(-1, 1, nx, endpoint=False)
    k = np.fft.fftfreq(nx, d=2.0 / nx) * 2 * np.pi
    u = (x ** 2) * np.cos(np.pi * x)
    dt = 1.0 / (nt - 1)

    def rhs(u):
        return (1e-4 * np.real(np.fft.ifft(-(k ** 2) * np.fft.fft(u)))
                + 5 * (u - u ** 3))

    out = {}
    for i in range(nt - 1):
        k1 = rhs(u)
        k2 = rhs(u + dt / 2 * k1)
        k3 = rhs(u + dt / 2 * k2)
        k4 = rhs(u + dt * k3)
        u = u + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        t = (i + 1) * dt
        for te in t_evals:
            if abs(t - te) < dt / 2:
                out[te] = u.copy()
    return x, out


def make_solver(device=None, mesh=None):
    def allen_cahn(f, x, t):
        return D(f, t) - 1e-4 * D(D(f, x), x) - 5.0 * (f - f ** 3)

    return Solver(allen_cahn, ndims=2, seed=0, domain=[(-1, 1), (0, 1)],
                  initial_condition=lambda x: x ** 2 * torch.cos(np.pi * x),
                  periodic={0: 10}, periodic_ic_decay=False,
                  model=SeparableModel, activation="Tanh",
                  layout="fa fa fa f", features=[64, 64, 64, 64],
                  device=device, mesh=mesh)


def main(iters_per_stage=4000, device=None):
    solver = make_solver(device)
    for eps in (1.0, 5.0, 20.0):  # one captured step: eps is a buffer
        solver.fit(niters=iters_per_stage, batch_size=64, lr=1e-3,
                   causal=eps, chunk_size=iters_per_stage, progress=False)

    x_ref, truths = spectral_truth()
    rels = []
    for te, ut in sorted(truths.items()):
        pred = solver.predict(x_ref, np.full_like(x_ref, te)).ravel()
        rels.append(float(np.linalg.norm(pred - ut) / np.linalg.norm(ut)))
    print("separable allen-cahn rel_l2(t=0.25/0.5/1.0) = "
          + " ".join(f"{r:.4f}" for r in rels))
    assert rels[0] < 0.05 and rels[-1] < 0.15, rels
    return solver, {"rel_l2": rels}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
