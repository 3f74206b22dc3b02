"""Workload 5 — inverse problem with a trainable coefficient, on
pydens_tpu_torch:

    f'(x) = 2*pi*cos(2*pi*x) - c,   f(0) = 1,

where `c` (the V-token variable 'new_var') is unknown.  An interior
constraint f(0.5) = 0 makes the problem well-posed; the solver recovers
c -> 2 and f -> sin(2*pi*x) + 1 - 2x via two-phase training.  The port of
examples/05.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/05_inverse_problem.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D, V


def odevar(f, x):
    return (D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)
            + V("new_var", data=np.array([1.0])))


def main(device=None):
    solver = Solver(odevar, ndims=1, initial_condition=1,
                    constraints=lambda f, x: f(np.array([0.5])), seed=0,
                    device=device)

    # Phase 1: freeze the unknown, pre-solve the equation with c = 1.
    solver.model.freeze_trainable(variables=("new_var",))
    solver.fit(niters=400, batch_size=500, lr=0.1)

    # Phase 2: unfreeze; the interior constraint drives c toward 2.
    solver.model.unfreeze_trainable(variables=["new_var"])
    solver.fit(niters=300, batch_size=100, lr=0.1,
               loss_terms=["equation", "constraint_0"])

    c = float(solver.params["variables"]["new_var"].detach().cpu()[0])
    xs = np.linspace(0, 1, 100)
    err = float(np.max(np.abs(solver.predict(xs).ravel()
                              - (np.sin(2 * np.pi * xs) + 1 - 2 * xs))))
    print(f"recovered coefficient c = {c:.3f} (true: 2)")
    print(f"max |approx - analytic|: {err:.4f}")
    assert abs(c - 2.0) < 0.35
    return solver, {"c": c, "err": err}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
