"""Multiscale 1D Poisson on pydens_tpu_torch — spectral bias and its
cure, suite-sized.

    u'' = -(2π)² sin(2πx) - 0.1 (2πk)² sin(2πkx),  u(0) = u(1) = 0,  k = 8

has the closed form u = sin(2πx) + 0.1 sin(2πkx): an O(1) slow mode plus
a small fast mode whose *source* dominates the residual (the (2πk)²
factor).  A raw-coordinate tanh MLP cannot train it at this budget;
random Fourier features at σ ≈ k (``fourier_features=(32, k)``) solve it.
Boundary conditions bind exactly through the ansatz.

Route on the card: the embedded chain (32 features: 65 inputs) trains on
the fused Taylor kernels, from the embedding's Taylor state; ``predict``
runs the fused MLP kernel after the embedding.  The port of examples/21.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/21_multiscale_poisson.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D

K = 8.0


def exact(x):
    return np.sin(2 * np.pi * x) + 0.1 * np.sin(2 * np.pi * K * x)


def main(device=None):
    def poisson(f, x):
        return (D(D(f, x), x)
                + (2 * np.pi) ** 2 * torch.sin(2 * np.pi * x)
                + 0.1 * (2 * np.pi * K) ** 2 * torch.sin(2 * np.pi * K * x))

    solver = Solver(poisson, ndims=1, seed=0, boundary_condition=0,
                    layout="fa fa f", features=[32, 32, 1],
                    activation="Tanh", fourier_features=(32, K),
                    device=device)
    solver.fit(niters=4000, batch_size=512, lr=3e-3, progress=False)

    xs = np.linspace(0, 1, 400)
    err = float(np.max(np.abs(solver.predict(xs).ravel() - exact(xs))))
    print(f"max abs error: {err:.4f}  (fast-mode amplitude: 0.1; "
          f"raw-coordinate net: 0.31)")
    # the fast mode is amplitude 0.1 — err must resolve well within it
    assert err < 0.05, err
    return solver, {"err": err}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
