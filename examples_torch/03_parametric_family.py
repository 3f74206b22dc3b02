"""Workload 3 — a parametric family of ODEs, on pydens_tpu_torch: one
network solves

    f'(x) = e * pi * cos(e * pi * x),  f(0) = 2

for every phase e in [0.5, 5.5] at once.  Analytic: f = sin(e*pi*x) + 2.
The port of examples/03.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/03_parametric_family.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D, NumpySampler as NS


def odeparam(f, x, e):
    return D(f, x) - e * np.pi * torch.cos(e * np.pi * x)


def main(device=None):
    solver = Solver(odeparam, ndims=1, initial_condition=2.0, nparams=1,
                    seed=0, device=device)
    sampler = NS("u", seed=0) & NS("u", low=.5, high=5.5, seed=1)
    solver.fit(niters=7000, batch_size=700, sampler=sampler, lr=0.01)

    xs = np.linspace(0, 1, 100)
    errs = {}
    for eps in (1.0, 2.5, 4.0):
        approx = solver.predict(xs, eps).ravel()
        true = np.sin(eps * np.pi * xs) + 2
        errs[eps] = float(np.max(np.abs(approx - true)))
        print(f"eps={eps}: max |approx - analytic| = {errs[eps]:.4f}")
        assert errs[eps] < 0.35
    return solver, {f"err_e{eps}": err for eps, err in errs.items()}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
