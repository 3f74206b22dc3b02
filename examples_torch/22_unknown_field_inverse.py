"""Unknown-FIELD inverse problem on pydens_tpu_torch: recover a
spatially-varying source.

    u''(x) = s(x),   u(0) = u(1) = 0,

where the source field s(x) is UNKNOWN — only scattered observations of
the solution u are available.  The true field is s = -π² sin(πx)
(so u = sin(πx)).  ``Field('s')`` parameterizes the unknown function by
its own small MLP whose weights train jointly with the solution network;
its leaves live in ``solver.params['variables']``.  The observations are
a tensor on the solver's device (a constraint subtracts a tensor, made
once before the fit).

Route on the card: the solution's chain takes the fused Taylor kernels on
every step (the field runs as plain PyTorch beside it); ``predict`` runs
the fused MLP kernel.  The port of examples/22.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/22_unknown_field_inverse.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D, Field
from pydens_tpu_torch.models.base import resolve_device


def main(device=None):
    rng = np.random.default_rng(0)
    obs_x = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    obs_u = np.sin(np.pi * obs_x).astype(np.float32)  # noiseless here
    obs_u = torch.as_tensor(obs_u, device=resolve_device(device))

    s_field = Field("s", features=[16, 1])

    def poisson(f, x):
        return D(D(f, x), x) - s_field(x)

    def data_misfit(f, x):
        return f(obs_x) - obs_u

    solver = Solver(poisson, ndims=1, seed=0, boundary_condition=0,
                    layout="fa fa f", features=[24, 24, 1],
                    activation="Tanh", constraints=data_misfit,
                    device=device)
    # Two stages: fit the solution hard against the data, then anneal the
    # learning rate so the field (read only through u'' = s) sharpens.
    solver.fit(niters=10000, batch_size=256, lr=5e-3,
               loss_terms={"equation": 1.0, "constraint_0": 1000.0},
               progress=False)
    solver.fit(niters=20000, batch_size=256, lr=1e-3,
               loss_terms={"equation": 1.0, "constraint_0": 1000.0},
               progress=False)

    xs = np.linspace(0, 1, 100)
    s_hat = s_field.predict(solver, xs).ravel()
    s_true = -np.pi ** 2 * np.sin(np.pi * xs)
    rel_s = float(np.linalg.norm(s_hat - s_true) / np.linalg.norm(s_true))
    err_u = float(np.max(np.abs(solver.predict(xs).ravel()
                                - np.sin(np.pi * xs))))
    print(f"recovered field rel L2: {rel_s:.4f}  "
          f"(max |s| = {np.pi**2:.1f}); solution max err: {err_u:.5f}")
    assert rel_s < 0.06, rel_s
    assert err_u < 0.005, err_u
    return solver, {"rel_s": rel_s, "err_u": err_u}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
