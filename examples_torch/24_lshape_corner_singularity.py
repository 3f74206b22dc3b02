"""L-shaped domain with a reentrant-corner singularity, on
pydens_tpu_torch.

    Δu = 0  on  Ω = (-1,1)² \\ [0,1)×(-1,0],   u = g on ∂Ω,

with boundary data from the exact singular solution

    u(r, θ) = r^(2/3) · sin(2θ/3),   θ ∈ [0, 3π/2],

the classic adaptive-FEM benchmark: u ∈ H^(1+2/3-ε) only — its gradient
blows up like r^(-1/3) at the corner.  The mesh-free PINN needs no
refinement strategy: interior collocation from a `GeometrySampler`
indicator, Dirichlet data as a fixed-point constraint (the exact-BC
ansatz covers boxes only).  The boundary data are a tensor on the
solver's device.

Route on the card: the chain takes the fused Taylor kernels on every
step (``laplace``: five streams); ``predict`` runs the fused MLP kernel.
The port of examples/24.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/24_lshape_corner_singularity.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, GeometrySampler, laplace
from pydens_tpu_torch.models.base import resolve_device


def u_exact(p):
    x, y = p[:, 0], p[:, 1]
    r = np.sqrt(x ** 2 + y ** 2)
    th = np.mod(np.arctan2(y, x), 2 * np.pi)
    return (r ** (2 / 3)) * np.sin(2 * th / 3)


def inside(p):
    # (-1,1)^2 minus the closed fourth quadrant
    return ~((p[..., 0] > 0) & (p[..., 1] < 0))


def lshape(seed):
    return GeometrySampler(inside, bbox=[(-1, 1), (-1, 1)],
                           oversample=4, seed=seed)


def boundary_pts(n):
    """Arc-length-uniform points on the 6-segment L-shape boundary."""
    t = (np.arange(n) + 0.5) / n * 8.0
    pts = np.zeros((n, 2))
    seg = [((0, 1), lambda s: np.c_[s, 0 * s]),          # (0,0)->(1,0)
           ((1, 2), lambda s: np.c_[1 + 0 * s, s - 1]),  # (1,0)->(1,1)
           ((2, 4), lambda s: np.c_[3 - s, 1 + 0 * s]),  # (1,1)->(-1,1)
           ((4, 6), lambda s: np.c_[-1 + 0 * s, 5 - s]),  # (-1,1)->(-1,-1)
           ((6, 7), lambda s: np.c_[s - 7, -1 + 0 * s]),  # (-1,-1)->(0,-1)
           ((7, 8), lambda s: np.c_[0 * s, s - 8])]       # (0,-1)->(0,0)
    for (lo, hi), fn in seg:
        m = (t >= lo) & (t < hi)
        pts[m] = fn(t[m])
    return pts.astype(np.float32)


def main(device=None):
    bp = boundary_pts(512)
    gb = torch.as_tensor(u_exact(bp).astype(np.float32).reshape(-1, 1),
                         device=resolve_device(device))

    def pde(f, x, y):
        return laplace(f, x, y)

    solver = Solver(pde, ndims=2, seed=0, domain=[(-1, 1), (-1, 1)],
                    layout="fa fa fa f", features=[32, 32, 32, 1],
                    activation="Tanh",
                    constraints=lambda f, x, y: f(bp[:, 0:1],
                                                  bp[:, 1:2]) - gb,
                    device=device)
    solver.fit(niters=4000, batch_size=1024, sampler=lshape(0), lr=3e-3,
               loss_terms={"equation": 1.0, "constraint_0": 500.0},
               progress=False)

    ev = lshape(99).sample(2000).astype(np.float32)
    truth = u_exact(ev)
    pred = solver.predict(ev).ravel()
    rel = float(np.linalg.norm(pred - truth) / np.linalg.norm(truth))
    # error concentrates at the corner, as theory says
    r2 = (ev ** 2).sum(axis=1)
    near = np.abs(pred - truth)[r2 < 0.05 ** 2]
    print(f"L-shape rel-L2: {rel:.4f}  "
          f"(max err near corner: {near.max() if near.size else 0:.4f})")
    assert rel < 0.03, rel
    return solver, {"rel_l2": rel}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
