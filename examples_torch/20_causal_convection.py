"""Causal training on advection-dominated transport, on pydens_tpu_torch.

Plain PINN training on the periodic convection equation

    u_t + c u_x = 0,   u(x, 0) = sin(2 pi x),   u(0, t) = u(1, t)

famously fails as ``c`` grows: with the loss summed uniformly over time,
the optimizer satisfies late times with a trivial (near-zero) field
before information has propagated from the initial condition, and gets
stuck there.  ``fit(causal=eps)`` cures this by weighting each time bin's
residual with ``exp(-eps * normalized cumulative residual at earlier
times)`` — late times only start to matter once early times are solved
(Wang, Sankaran & Perdikaris-style causality, with a scale-free
temperature; the exact-IC ansatz anchors t0).  ``eps`` is a runtime
scalar, so annealing it across fit calls replays one captured step.

At c >= 10 the bottleneck becomes spectral: random Fourier features on
the t column with the gated modified MLP (``main(C=10)``) take over.  The
periodic embedding takes the traversal's plain PyTorch version in
training; ``predict`` runs the fused MLP kernel after the embedding.  The
port of examples/20.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/20_causal_convection.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D

C = 4.0


def main(C=C, device=None):
    def convection(f, x, t):
        return D(f, t) + C * D(f, x)

    # At high c the t-axis content is high-frequency: add random Fourier
    # features on t (x keeps its exact periodic embedding — RFF dims
    # default to the non-periodic columns).  sigma ~ the dominant
    # t-frequency, NOT above it.
    rff = None if C <= 4 else (32, float(C))
    akw = (dict(layout="fa fa fa f") if C <= 4
           else dict(arch="modified"))  # gated body at c >= 10
    solver = Solver(convection, ndims=2, seed=0, periodic=(0,),
                    initial_condition=lambda x: torch.sin(2 * np.pi * x),
                    activation="Tanh", features=[64, 64, 64, 1],
                    fourier_features=rff, device=device, **akw)
    # Anneal the causal temperature; eps is a buffer — one captured step.
    solver.fit(niters=20000, batch_size=2048, lr=1e-3, causal=5.0,
               chunk_size=20000, progress=False)
    solver.fit(niters=20000, batch_size=2048, lr=1e-3, causal=20.0,
               chunk_size=20000, progress=False)

    xs = np.linspace(0, 1, 129)
    ts = np.linspace(0, 1, 201)
    X, T = np.meshgrid(xs, ts)
    pred = solver.predict(X.ravel(), T.ravel()).ravel()
    true = np.sin(2 * np.pi * (X - C * T)).ravel()
    rel = float(np.linalg.norm(pred - true) / np.linalg.norm(true))
    print(f"c={C} causal rel_l2 = {rel:.4f}")
    assert rel < 0.25, rel
    return solver, {"rel_l2": rel}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
