"""Eigenvalue problem on pydens_tpu_torch: ground state of the 1D
Dirichlet Laplacian.

    -u''(x) = lam * u(x),   u(0) = u(1) = 0,

with BOTH the eigenfunction u and the eigenvalue lam unknown.  Ground
truth: lam = pi^2 ~ 9.8696, u = sqrt(2) sin(pi x).

* ``V('lam')`` holds the unknown eigenvalue (a trainable scalar);
* the exact-BC ansatz (``boundary_condition=0``) kills the boundary
  conditions by construction;
* a NORMALIZATION constraint ``mean(u^2) - 1 = 0`` on a fixed quadrature
  grid removes the trivial solution u == 0;
* a POSITIVITY constraint ``min(u, 0) = 0`` selects the nodeless ground
  state;
* a point ANCHOR ``u(1/2) = sqrt(2)`` breaks the u -> -u sign symmetry
  early.

Training: Adam to land in the basin, then the Gauss-Newton/LM finisher
(``optimizer='LM'``) polishes the coupled (network, lam) least-squares
system; each CG iteration of an LM step runs the fused Taylor tangent
kernel.  The port of examples/29.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/29_eigenvalue_problem.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D, V


def main(device=None):
    xq = np.linspace(0.0, 1.0, 257, dtype=np.float32)[:, None]

    def helmholtz(f, x):
        return D(D(f, x), x) + V("lam", data=np.array([8.0])) * f

    def normalization(fwd, x):
        # Midpoint-rule integral of u^2 over [0, 1] on the fixed grid.
        return torch.mean(fwd(xq) ** 2) - 1.0

    def positivity(fwd, x):
        # Nodeless (ground-state) selection: penalize negative excursions.
        u = fwd(xq)
        return torch.minimum(u, torch.zeros_like(u))

    def anchor(fwd, x):
        # Sign-symmetry breaker: the ground state's known peak value.
        return fwd(0.5) - np.sqrt(2.0, dtype=np.float32)

    solver = Solver(helmholtz, ndims=1, boundary_condition=0,
                    constraints=[normalization, positivity, anchor],
                    layout="fa fa f", features=[24, 24, 1],
                    activation="Tanh", seed=0, device=device)
    terms = {"equation": 1.0, "constraint_0": 20.0, "constraint_1": 20.0,
             "constraint_2": 20.0}
    solver.fit(niters=4000, batch_size=256, lr=5e-3, loss_terms=terms,
               progress=False)
    # Gauss-Newton/LM polish of the coupled least-squares system (network
    # weights + lam together in the normal equations).
    solver.fit(niters=40, batch_size=512, optimizer="LM", resample=False,
               loss_terms=terms, progress=False)

    lam = float(solver.params["variables"]["lam"].detach().cpu().ravel()[0])
    xs = np.linspace(0, 1, 501)
    u = solver.predict(xs).ravel()
    u_true = np.sqrt(2.0) * np.sin(np.pi * xs)
    rel_l2 = float(np.linalg.norm(u - u_true) / np.linalg.norm(u_true))
    lam_err = abs(lam - np.pi ** 2) / np.pi ** 2
    print(f"lam = {lam:.6f} (pi^2 = {np.pi ** 2:.6f}), "
          f"rel err {lam_err:.2e}; eigenfunction rel-L2 {rel_l2:.2e}")
    assert lam_err < 1e-3, lam_err
    assert rel_l2 < 0.005, rel_l2
    return solver, {"lam": lam, "lam_err": lam_err, "rel_l2": rel_l2}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
