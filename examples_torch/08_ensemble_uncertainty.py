"""Ensemble training and epistemic uncertainty on pydens_tpu_torch: 8
networks train in one step (the fused Taylor kernels take the members on
their grid's second axis, one launch for all), and their spread
quantifies where the learned solution is trustworthy.

Route on the card: the fused Taylor kernels with the member axis on every
step; ``predict`` and ``predict_std`` run the fused MLP kernel once for
all eight members.  The port of examples/08.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/08_ensemble_uncertainty.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D


def main(device=None):
    def ode(f, x):
        return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)

    solver = Solver(ode, ndims=1, initial_condition=.5, activation="Tanh",
                    layout="fafaf", features=[12, 10, 1], seed=0, n_models=8,
                    device=device)
    solver.fit(niters=500, batch_size=400, lr=0.02)

    xs = np.linspace(0, 1, 100)
    mean = solver.predict(xs).ravel()
    std = solver.predict_std(xs).ravel()
    true = np.sin(2 * np.pi * xs) + .5
    err = np.abs(mean - true)
    print(f"ensemble mean max err: {err.max():.4f}")
    print(f"uncertainty range: [{std.min():.5f}, {std.max():.5f}]")
    # the ensemble mean should be at least as good as typical members
    assert err.max() < 0.05
    # uncertainty should be small where the fit is good
    assert std.mean() < 0.05
    return solver, {"err_max": float(err.max()),
                    "std_mean": float(std.mean()),
                    "std_min": float(std.min()), "std_max": float(std.max())}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
