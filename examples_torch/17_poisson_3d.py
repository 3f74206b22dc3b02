"""3D Poisson on the unit cube on pydens_tpu_torch — manufactured
solution:

    laplace(u) = -3 pi^2 sin(pi x) sin(pi y) sin(pi z),  u = 0 on all faces
    =>  u = sin(pi x) sin(pi y) sin(pi z)

The Dirichlet-product ansatz in three spatial dimensions (the boundary
condition holds exactly on every face of the cube by construction) and
quasi-Monte-Carlo collocation in 3D.

Route on the card: the fused Taylor kernels on every step (seven streams:
the value, three first- and three pure second-order taps); ``predict``
runs the fused MLP kernel.  The port of examples/17.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/17_poisson_3d.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D, HaltonSampler


def main(device=None):
    def pde(f, x, y, z):
        lap = D(D(f, x), x) + D(D(f, y), y) + D(D(f, z), z)
        return lap + 3 * np.pi ** 2 * (torch.sin(np.pi * x)
                                       * torch.sin(np.pi * y)
                                       * torch.sin(np.pi * z))

    solver = Solver(pde, ndims=3, boundary_condition=0, seed=0,
                    layout="fa fa f", features=[48, 48, 1],
                    activation="Tanh", device=device)
    assert solver._plan_ok
    solver.fit(niters=2500, batch_size=2048, lr=2e-3,
               sampler=HaltonSampler(dim=3), progress=False)

    # Boundary exact at any parameters; interior vs the manufactured field.
    edge = np.linspace(0, 1, 5)
    assert np.max(np.abs(solver.predict(
        np.zeros(5), edge, edge[::-1]))) < 1e-6
    rng = np.random.default_rng(0)
    pts = rng.uniform(size=(2000, 3)).astype(np.float32)
    pred = solver.predict(pts).ravel()
    true = np.prod(np.sin(np.pi * pts), axis=1)
    err = float(np.max(np.abs(pred - true)))
    print(f"max |u - u_exact| over 2000 interior points: {err:.4f}")
    assert err < 0.05, err
    return solver, {"err": err}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
