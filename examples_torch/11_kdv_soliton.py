"""Workload 11 — Korteweg–de Vries soliton (third-order dispersion), on
pydens_tpu_torch:

    u_t + 6 u u_x + u_xxx = 0   on x in [-5, 5], t in [0, 0.5]
    u(x, 0) = 2 sech^2(x + 2)

The exact solution is the right-traveling c=4 soliton
``u(x, t) = 2 sech^2(x - 4t + 2)``.  The third-order derivative rides the
Taylor plan (all taps in one network traversal); the fused Taylor kernels
take orders up to two, so this plan runs the traversal's plain PyTorch
version, and ``predict`` the fused MLP kernel.  The port of examples/11.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/11_kdv_soliton.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D, NumpySampler as NS


def kdv(f, x, t):
    return D(f, t) + 6 * f * D(f, x) + D(D(D(f, x), x), x)


def main(device=None):
    solver = Solver(kdv, ndims=2, domain=[(-5, 5), (0, 0.5)],
                    initial_condition=lambda x: 2.0 / torch.cosh(x + 2.0) ** 2,
                    layout="fafaf", features=[24, 24, 1], activation="Tanh",
                    seed=0, device=device)
    assert solver._plan_ok  # third-order taps are planned
    sampler = (NS("u", low=-5, high=5, seed=0)
               & NS("u", low=0, high=0.5, seed=1))
    solver.fit(niters=5000, batch_size=1024, lr=0.005, sampler=sampler)

    xs = np.linspace(-5, 5, 101)
    errs = {}
    for t in (0.0, 0.25, 0.5):
        pred = solver.predict(xs, np.full_like(xs, t)).ravel()
        true = 2.0 / np.cosh(xs - 4 * t + 2.0) ** 2
        errs[t] = float(np.max(np.abs(pred - true)))
        print(f"t={t:4}: max |approx - soliton| = {errs[t]:.4f}")
    worst = max(errs.values())
    print(f"final residual loss: {solver.losses[-1]:.2e}")
    assert worst < 0.05
    return solver, {"worst": worst, **{f"err_t{t}": e
                                       for t, e in errs.items()}}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
