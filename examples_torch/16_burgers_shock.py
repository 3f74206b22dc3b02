"""Viscous Burgers equation on pydens_tpu_torch — the canonical PINN
benchmark (steepening shock at x = 0):

    u_t + u u_x = nu u_xx,   nu = 0.01 / pi
    u(0, x) = -sin(pi x),    u(t, -1) = u(t, 1) = 0

on x in [-1, 1], t in [0, 1].  The exact solution comes from the
Cole–Hopf transform, evaluated here with Gauss–Hermite quadrature
(Basdevant et al. 1986) — the shock half-width at t = 1 is ~nu, far
below the uniform collocation density, the regime the residual-based
adaptive sampler (`fit(adaptive=r)`) exists for.

Feature mix: boundary condition bound exactly by the ansatz product,
exact IC via the gate, non-unit domain with an explicit product sampler,
adaptive collocation concentrating points at the shock, the gated
modified-MLP body, and a full-batch L-BFGS polish at 10,000 points.

Route on the card: the modified MLP takes the traversal's plain PyTorch
version in training and its plain forward in ``predict`` (no fused
kernel covers its gates).  The port of examples/16.

From the repository root, on the CUDA card (``--cpu``: on the CPU; the
budget takes tens of minutes there)::

    PYTHONPATH=. python examples_torch/16_burgers_shock.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D, NumpySampler as NS

NU = 0.01 / np.pi


def burgers_exact(x, t, n_quad=128):
    """Cole–Hopf solution via Gauss–Hermite quadrature (float64)."""
    x = np.asarray(x, np.float64)
    t = np.asarray(t, np.float64)
    z, w = np.polynomial.hermite.hermgauss(n_quad)
    a = np.sqrt(4.0 * NU * np.maximum(t, 1e-12))[:, None]
    y = x[:, None] - z[None, :] * a  # (N, n_quad)
    expo = -np.cos(np.pi * y) / (2.0 * np.pi * NU)
    expo -= expo.max(axis=1, keepdims=True)  # stabilize
    f = np.exp(expo)
    num = np.sum(w * np.sin(np.pi * y) * f, axis=1)
    den = np.sum(w * f, axis=1)
    out = -num / den
    return np.where(t < 1e-12, -np.sin(np.pi * x), out)


def make_solver(device=None):
    """The modified-MLP solver and its product sampler over the domain."""
    def burgers(f, x, t):
        return D(f, t) + f * D(f, x) - NU * D(D(f, x), x)

    solver = Solver(burgers, ndims=2, seed=0,
                    domain=[(-1.0, 1.0), (0.0, 1.0)],
                    initial_condition=lambda x: -torch.sin(np.pi * x),
                    boundary_condition=0,
                    arch="modified", features=[20] * 8 + [1],
                    activation="Tanh", device=device)
    sampler = (NS("u", low=-1, high=1, seed=0)
               & NS("u", low=0, high=1, seed=1))
    return solver, sampler


def main(device=None):
    solver, sampler = make_solver(device)
    # Adam with adaptive (residual-weighted) collocation, then a full-batch
    # L-BFGS polish on a fixed point set.
    solver.fit(niters=6000, batch_size=2048, lr=2e-3, sampler=sampler,
               adaptive=8, progress=False)
    solver.fit(niters=1000, batch_size=10000, optimizer="LBFGS",
               sampler=sampler, resample=False, progress=False)

    xs = np.linspace(-1, 1, 401)
    worst, preds, trues = 0.0, [], []
    for t_eval in (0.25, 0.5, 1.0):
        pred = solver.predict(xs, np.full_like(xs, t_eval)).ravel()
        true = burgers_exact(xs, np.full_like(xs, t_eval))
        preds.append(pred)
        trues.append(true)
        err = float(np.max(np.abs(pred - true)))
        worst = max(worst, err)
        print(f"t={t_eval}: max |u - u_exact| = {err:.4f}")
    rel_l2 = float(np.linalg.norm(np.concatenate(preds)
                                  - np.concatenate(trues))
                   / np.linalg.norm(np.concatenate(trues)))
    print(f"relative L2 error: {rel_l2:.5f}")
    assert worst < 0.06, worst        # pointwise, AT the shock
    assert rel_l2 < 0.008, rel_l2     # global
    return solver, {"worst": worst, "rel_l2": rel_l2}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
