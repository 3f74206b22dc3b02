"""Deep Ritz on a low-regularity problem on pydens_tpu_torch:
discontinuous source.

    -u''(x) = f(x),  u(0) = u(1) = 0,
     f(x)   = +1 for x < 1/2,  -1 for x > 1/2.

The weak solution is the piecewise quadratic

    u(x) = -x²/2 + x/4          (x ≤ 1/2)
         =  x²/2 - 3x/4 + 1/4   (x ≥ 1/2)

— C¹ but not C²: u'' jumps at x = 1/2.  A strong-form PINN asks a smooth
network's second derivative to match that jump pointwise, which it
cannot; the Deep Ritz energy (``Solver(formulation='variational')``)

    E[u] = ∫ ½ u'² - f·u dx

samples only u and u', so the network never has to represent the jump.
The exact-boundary ansatz supplies the admissible set.  The recipe:
quasi-Monte-Carlo collocation (HaltonSampler) plus a fixed-batch L-BFGS
finish; the strong form with the same sampler and budget is the
comparison.

Route on the card: both forms take the fused Taylor kernels on every
Adam and L-BFGS step (the energy two streams, the residual three);
``predict`` runs the fused MLP kernel.  The port of examples/23.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/23_deep_ritz_low_regularity.py [--cpu]
"""

import sys

import numpy as np
import torch

import pydens_tpu_torch as pdt
from pydens_tpu_torch import Solver, D
from pydens_tpu_torch.samplers import HaltonSampler


def u_true(xs):
    return np.where(xs <= 0.5, -xs ** 2 / 2 + xs / 4,
                    xs ** 2 / 2 - 3 * xs / 4 + 0.25)


def main(device=None):
    source = pdt.lift(lambda z: torch.sign(0.5 - z))  # +1 left, -1 right

    def energy(f, x):
        return 0.5 * D(f, x) ** 2 - source(x) * f

    def residual(f, x):
        return D(D(f, x), x) + source(x)

    common = dict(ndims=1, seed=0, boundary_condition=0,
                  layout="fa fa f", features=[24, 24, 1], activation="Tanh",
                  device=device)
    xs = np.linspace(0, 1, 401)
    truth = u_true(xs)
    rel, solvers = {}, {}
    for name, eq, kw in [("variational", energy,
                          {"formulation": "variational"}),
                         ("residual", residual, {})]:
        solver = Solver(eq, **common, **kw)
        qmc = HaltonSampler(dim=1)
        solver.fit(niters=4000, batch_size=2048, lr=5e-3, sampler=qmc,
                   progress=False)
        solver.fit(niters=500, batch_size=4096, optimizer="LBFGS",
                   sampler=qmc, resample=False, progress=False)
        pred = solver.predict(xs).ravel()
        rel[name] = float(np.linalg.norm(pred - truth)
                          / np.linalg.norm(truth))
        solvers[name] = solver
    print(f"rel-L2 vs weak solution: variational {rel['variational']:.5f}  "
          f"residual {rel['residual']:.5f}")
    assert rel["variational"] < 0.005, rel
    assert rel["variational"] < rel["residual"] / 3, rel
    return solvers["variational"], rel


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
