"""Data assimilation / parameter identification on pydens_tpu_torch:
recover an unknown diffusivity from noisy observations of the temperature
field.

    u_t = a * u_xx  on [0,1] x [0,0.2],  u(x,0) = sin(pi x),  u = 0 at ends
    true a = 0.5  =>  u = sin(pi x) exp(-a pi^2 t)

We observe u at scattered space-time points (with noise), make `a` a
trainable V-token variable, and add a data-misfit constraint.  The solver
recovers `a` and the full field simultaneously.  The port of examples/10;
the observations are a tensor on the solver's device (a constraint
subtracts a tensor, made once before the fit).

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/10_data_assimilation.py [--cpu]
"""

import sys

import numpy as np
import torch

import pydens_tpu_torch as pdt
from pydens_tpu_torch import Solver, D, V
from pydens_tpu_torch.models.base import resolve_device

TRUE_A = 0.5


def main(device=None):
    rng = np.random.default_rng(0)
    # synthetic noisy observations of the true solution
    obs_x = rng.uniform(0.1, 0.9, size=(64, 1)).astype(np.float32)
    obs_t = rng.uniform(0.0, 0.2, size=(64, 1)).astype(np.float32)
    obs_u = (np.sin(np.pi * obs_x) * np.exp(-TRUE_A * np.pi ** 2 * obs_t)
             + 0.01 * rng.normal(size=obs_x.shape)).astype(np.float32)
    obs_u = torch.as_tensor(obs_u, device=resolve_device(device))

    def heat(f, x, t):
        return D(f, t) - V("a", data=np.array([1.0])) * D(D(f, x), x)

    def data_misfit(f, x, t):
        return f(obs_x, obs_t) - obs_u

    solver = Solver(heat, ndims=2, seed=0,
                    initial_condition=lambda x: torch.sin(np.pi * x),
                    boundary_condition=0.0,
                    domain=[(0, 1), (0, 0.2)],
                    layout="fa fa f", features=[24, 24, 1],
                    activation="Tanh",
                    constraints=data_misfit, device=device)
    solver.fit(niters=3000, batch_size=512, lr=0.005,
               loss_terms={"equation": 1.0, "constraint_0": 50.0},
               sampler=pdt.NumpySampler("u", seed=0)
               & pdt.NumpySampler("u", low=0, high=0.2, seed=1))

    a_hat = float(solver.params["variables"]["a"].detach().cpu()[0])
    print(f"recovered diffusivity a = {a_hat:.4f} (true: {TRUE_A})")
    xs = np.linspace(0, 1, 50)
    pred = solver.predict(xs, 0.1).ravel()
    true = np.sin(np.pi * xs) * np.exp(-TRUE_A * np.pi ** 2 * 0.1)
    err = float(np.max(np.abs(pred - true)))
    print(f"field max err at t=0.1: {err:.4f}")
    assert abs(a_hat - TRUE_A) < 0.05
    assert err < 0.05
    return solver, {"a": a_hat, "err": err}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
