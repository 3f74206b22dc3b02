"""Workload 4 — heat equation on a 2D plate with parametric diffusivity,
on pydens_tpu_torch:

    d2f/dx2 + d2f/dy2 = a * df/dt,   (x, y) in [0,1]^2,  t in [0, 0.5]

with f = 0 on the plate edge (bound exactly) and initial temperature
f(x, y, 0) = 10 * x * y * (1-x) * (1-y).  The inverse diffusivity `a` is a
sampled parameter in [0.1, 4] — one network covers the whole family.  The
port of examples/04.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/04_heat_parametric.py [--cpu]
"""

import sys

import numpy as np

from pydens_tpu_torch import Solver, D, NumpySampler as NS


def pde(f, x, y, t, a):
    return D(D(f, x), x) + D(D(f, y), y) - a * D(f, t)


def main(device=None):
    solver = Solver(pde, ndims=3, nparams=1,
                    initial_condition=lambda x, y: 10 * x * y * (1 - x) * (1 - y),
                    boundary_condition=0, layout="fafaf",
                    features=[30, 40, 1], activation="Sigmoid", seed=0,
                    device=device)
    sampler = NS("u", dim=2, seed=0) & NS("u", low=0, high=.5, seed=1) \
        & NS("u", low=.1, high=4, seed=2)
    solver.fit(niters=1000, batch_size=1500, sampler=sampler, lr=0.001)

    print(f"final residual loss: {solver.losses[-1]:.5f}")
    # Initial condition binds exactly at t=0 for any diffusivity.
    pts = np.random.default_rng(0).uniform(size=(50, 2)).astype(np.float32)
    pred0 = solver.predict(pts[:, 0:1], pts[:, 1:2], 0.0, 1.0).ravel()
    true0 = 10 * pts[:, 0] * pts[:, 1] * (1 - pts[:, 0]) * (1 - pts[:, 1])
    ic_err = float(np.max(np.abs(pred0 - true0)))
    print(f"max IC violation at t=0: {ic_err:.2e}")
    # Mean plate temperature decays in time (heat dissipates to the edge).
    grid = np.stack(np.meshgrid(np.linspace(0, 1, 40),
                                np.linspace(0, 1, 40), indexing="ij"),
                    -1).reshape(-1, 2)
    means = [float(solver.predict(grid[:, 0:1], grid[:, 1:2], t, 1.0).mean())
             for t in (0.0, 0.2, 0.45)]
    print("mean temperature at t=0, 0.2, 0.45:",
          [round(m, 4) for m in means])
    assert means[0] > means[-1]
    return solver, {"means": means, "ic_err": ic_err}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
