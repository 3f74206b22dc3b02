"""Workload 13 — simply-supported plate bending (2D biharmonic), on
pydens_tpu_torch:

    nabla^4 u = u_xxxx + 2 u_xxyy + u_yyyy = q   on [0, 1]^2
    u = 0 on the boundary                (Dirichlet, exact via the ansatz)
    u_xx = 0 on x-edges, u_yy = 0 on y-edges   (bending moments, via
                                                multi-index fwd.grad)

With the sinusoidal load ``q = 4 pi^4 sin(pi x) sin(pi y)`` the exact
deflection is ``u = sin(pi x) sin(pi y)`` (Navier's plate solution).  The
residual needs the pure quads u_xxxx/u_yyyy AND the mixed quad u_xxyy —
all ride the order-4 Taylor plan (one network traversal for every tap; the
traversal's plain PyTorch version, since the fused Taylor kernels take
orders up to two), then an L-BFGS polish.  The port of examples/13.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/13_plate_bending.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D

W = np.pi


def plate(f, x, y):
    uxx = D(D(f, x), x)
    uyy = D(D(f, y), y)
    bih = D(D(uxx, x), x) + 2 * D(D(uxx, y), y) + D(D(uyy, y), y)
    # Normalize by the load scale so the residual is O(1).
    return bih / (4 * W ** 4) - torch.sin(W * x) * torch.sin(W * y)


def main(device=None):
    e = np.linspace(0, 1, 17).astype(np.float32)
    z, o = np.zeros_like(e), np.ones_like(e)
    cons = (  # bending moment = 0 on each edge
        lambda f, x, y: f.grad(z, e, wrt=(0, 0)),   # x = 0
        lambda f, x, y: f.grad(o, e, wrt=(0, 0)),   # x = 1
        lambda f, x, y: f.grad(e, z, wrt=(1, 1)),   # y = 0
        lambda f, x, y: f.grad(e, o, wrt=(1, 1)))   # y = 1

    solver = Solver(plate, ndims=2, boundary_condition=0, seed=0,
                    layout="fa fa f", features=[32, 32, 1],
                    activation="Tanh", constraints=cons, device=device)
    assert solver._plan_ok  # pure AND mixed quads are planned
    assert (0, 0, 1, 1) in solver._plan_derivs
    lt = {"equation": 1.0, "constraint_0": 5.0, "constraint_1": 5.0,
          "constraint_2": 5.0, "constraint_3": 5.0}
    # Convergence is steeply nonlinear in the Adam budget (examples/13:
    # 1000+80 missed the bound); 1600+120 keeps a real margin.
    solver.fit(niters=1600, batch_size=512, lr=0.01, loss_terms=lt)
    solver.fit(niters=120, batch_size=2048, optimizer="LBFGS",
               resample=False, loss_terms=lt)

    g = np.linspace(0, 1, 41)
    X, Y = np.meshgrid(g, g)
    pred = solver.predict(X.ravel(), Y.ravel()).ravel()
    true = (np.sin(W * X) * np.sin(W * Y)).ravel()
    err = float(np.max(np.abs(pred - true)))
    print(f"max |approx - Navier solution| = {err:.4f}")
    print(f"final loss: {solver.losses[-1]:.2e}")
    assert err < 0.05
    return solver, {"err": err, "final_loss": float(solver.losses[-1])}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
