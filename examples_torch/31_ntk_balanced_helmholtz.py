"""NTK-trace loss balancing on a high-frequency Helmholtz equation, on
pydens_tpu_torch — the regime where the balancing STATISTIC matters.

    u'' + k^2 u = 0,   u(0) = 0,   u'(0) = k,   k = 12   on x in [0, 1]

with PENALTY initial conditions (constraints, not the bound ansatz), so
the fit carries three loss terms whose natural scales differ by O(k^4).
Exact solution: ``u = sin(k x)``.

Why ``loss_balancing='ntk'``: the equation residual of an oscillatory
solution oscillates per collocation point, so the batch-summed gradient
magnitude that the default ``'grad'`` statistic reads partially cancels;
the NTK trace ``tr(K_j) = ||d r_j / d theta||_F^2`` sums per-row Jacobian
norms (Wang/Yu/Perdikaris, arXiv 2007.14527 §4).  The trace is
Hutchinson-estimated with Rademacher probes; terms with ≤ 4 residual rows
(the two pointwise ICs) are enumerated exactly.

Route on the card: the chain takes the fused Taylor kernels on every
training step and on each rebalance step (a second captured graph: one
forward and the backward once a probe); ``predict`` runs the fused MLP
kernel.  The port of examples/31.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/31_ntk_balanced_helmholtz.py [--cpu]
"""

import sys

import numpy as np

from pydens_tpu_torch import D, Solver

K = 12.0


TERMS = {"equation": 1.0, "constraint_0": 1.0, "constraint_1": 1.0}


def make_solver(device=None):
    """The Helmholtz solver, its initial conditions as penalty terms."""
    zero = np.array([0.0], np.float32)
    return Solver(lambda f, x: D(D(f, x), x) + K * K * f,
                  ndims=1, seed=0,
                  layout="fa fa fa f", features=[48, 48, 48, 1],
                  activation="Tanh",
                  constraints=(lambda f, x: f(zero),
                               lambda f, x: f.grad(zero, wrt=0) - K),
                  device=device)


def main(device=None):
    solver = make_solver(device)
    solver.fit(niters=4000, batch_size=1024, lr=0.002, loss_terms=TERMS,
               loss_balancing="ntk", progress=False)

    wts = np.asarray(solver.history[-1]["balanced_weights"])
    print(f"balanced weights: {np.round(wts, 3)}")
    assert wts[0] == 1.0  # the equation term anchors the scale
    assert np.all(np.isfinite(wts)) and np.all(wts > 0)

    xs = np.linspace(0.0, 1.0, 201)
    err = float(np.max(np.abs(solver.predict(xs).ravel() - np.sin(K * xs))))
    print(f"max err vs sin(kx): {err:.4f}")
    assert err < 0.03  # unbalanced stalls at ~0.19
    return solver, {"err": err, "balanced_weights": wts.tolist()}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
