"""Nonlinear Schrödinger equation on pydens_tpu_torch: the bright soliton
as a 2-component real system (complex fields via real/imaginary parts):

    i h_t + h_xx / 2 + |h|^2 h = 0     on x in [-5, 5], t in [0, pi/2]
    h(x, 0) = sech(x)

The exact solution is the standing soliton ``h = sech(x) exp(i t / 2)``.
With h = hr + i hi the system is

    hr_t + hi_xx / 2 + (hr^2 + hi^2) hi = 0      (imag part)
   -hi_t + hr_xx / 2 + (hr^2 + hi^2) hr = 0      (real part)

Feature mix: non-unit ``domain`` with an explicit product sampler (the
default sampler ignores ``domain`` — reference quirk parity), periodic
Fourier embedding in x, exact vector IC at t = 0 kept for all t
(``periodic_ic_decay=False``), and the coupled cubic-nonlinear system on
the Taylor plan.

Route on the card: the embedded chain trains on the fused Taylor
kernels, from the embedding's Taylor state; ``predict`` runs the fused MLP
kernel after the embedding.  The port of examples/15.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/15_schrodinger_soliton.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import Solver, D, NumpySampler as NS


def main(device=None):
    def nls(f, x, t):
        hr, hi = f[:, 0:1], f[:, 1:2]
        mag2 = hr * hr + hi * hi
        return (
            D(hr, t) + 0.5 * D(D(hi, x), x) + mag2 * hi,
            -D(hi, t) + 0.5 * D(D(hr, x), x) + mag2 * hr,
        )

    def ic(x):
        return torch.stack([1.0 / torch.cosh(x), torch.zeros_like(x)],
                           dim=-1)

    # periodic_ic_decay=False: the sech tails are ~1.3% of peak at x=+-5,
    # so the wrap probe would flag the truncation kink — it is deliberate,
    # standard for solitons (the final max-error assert is the evidence).
    solver = Solver(nls, ndims=2, seed=0,
                    domain=[(-5.0, 5.0), (0.0, float(np.pi / 2))],
                    periodic=(0,), initial_condition=ic,
                    periodic_ic_decay=False,
                    layout="fa fa fa f", features=[48, 48, 48, 2],
                    activation="Tanh", device=device)
    assert solver._plan_ok
    sampler = (NS("u", low=-5, high=5, seed=0)
               & NS("u", low=0, high=np.pi / 2, seed=1))
    solver.fit(niters=2500, batch_size=1024, lr=2e-3, sampler=sampler,
               progress=False)
    solver.fit(niters=800, batch_size=2048, lr=3e-4, sampler=sampler,
               progress=False)

    xs = np.linspace(-5, 5, 101)
    errs = []
    for t_eval in (np.pi / 4, np.pi / 2):
        pred = solver.predict(xs, np.full_like(xs, t_eval))
        true_r = np.cos(t_eval / 2) / np.cosh(xs)
        true_i = np.sin(t_eval / 2) / np.cosh(xs)
        err = float(np.max(np.hypot(pred[:, 0] - true_r,
                                    pred[:, 1] - true_i)))
        print(f"t={t_eval:.3f}: max |h - h_exact| = {err:.4f}")
        errs.append(err)
        assert err < 0.05, err
    return solver, {"err": errs}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
