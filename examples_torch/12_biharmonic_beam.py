"""Workload 12 — Euler–Bernoulli clamped beam (fourth-order/biharmonic),
on pydens_tpu_torch:

    u'''' = q          on x in [0, 1]   (uniform load q = 384)
    u(0) = u(1) = 0    (Dirichlet, bound exactly by the ansatz)
    u'(0) = u'(1) = 0  (clamping, via fwd.grad constraints)

The exact deflection is ``u(x) = 16 x^2 (1 - x)^2`` (midspan deflection 1).
Fourth-order derivatives ride the Taylor plan: value + first + second +
third + fourth directional taps propagate through ONE network traversal.

Route on the card: the traversal's plain PyTorch version (the fused
Taylor kernels take orders up to two), as examples_torch/13; then an
L-BFGS polish on a fixed batch; ``predict`` runs the fused MLP kernel.
The port of examples/12.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/12_biharmonic_beam.py [--cpu]
"""

import sys

import numpy as np

from pydens_tpu_torch import Solver, D


def beam(f, x):
    # Normalize by the load so the residual is O(1) from the start.
    return (D(D(D(D(f, x), x), x), x) - 384.0) / 384.0


def main(device=None):
    left = np.array([0.0], np.float32)
    right = np.array([1.0], np.float32)
    solver = Solver(beam, ndims=1, boundary_condition=0, seed=0,
                    layout="fa fa f", features=[24, 24, 1],
                    activation="Tanh",
                    constraints=(lambda f, x: f.grad(left, wrt=0),
                                 lambda f, x: f.grad(right, wrt=0)),
                    device=device)
    assert solver._plan_ok  # fourth-order taps are planned
    lt = {"equation": 1.0, "constraint_0": 10.0, "constraint_1": 10.0}
    solver.fit(niters=2500, batch_size=512, lr=0.01, loss_terms=lt)
    # Full-batch L-BFGS polish: Adam plateaus ~0.03 max error; L-BFGS
    # drives it to ~1e-4.
    solver.fit(niters=200, batch_size=2048, optimizer="LBFGS",
               resample=False, loss_terms=lt)

    xs = np.linspace(0, 1, 101)
    true = 16.0 * xs ** 2 * (1 - xs) ** 2
    err = float(np.max(np.abs(solver.predict(xs).ravel() - true)))
    print(f"max |approx - analytic deflection| = {err:.4f}")
    print(f"final loss: {solver.losses[-1]:.2e}")
    assert err < 0.005
    return solver, {"err": err, "final_loss": float(solver.losses[-1])}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
