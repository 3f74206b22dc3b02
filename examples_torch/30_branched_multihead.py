"""Branched multi-head networks for systems on pydens_tpu_torch: one
shared trunk, one dense head per unknown — the layout 'B' branch token.

Lotka-Volterra predator-prey dynamics

    u' = u - u v        (prey)
    v' = -1.5 v + u v   (predator)
    u(0) = 2,  v(0) = 1      on t in [0, 2]

The network is a shared representation trunk with two separate heads::

    layout   = 'fa fa B f .'                      # trunk, branch, concat
    branches = [dict(layout='fa f', features=[16, 1])]

Column 0 (the main path's 'f' head) models the prey, column 1 (the
branch's own two-layer head) the predator — the ``.`` join concatenates
branch features after the main path's.  Branch layers are addressable in
``freeze_layers`` as ``br1_fc1``, ``br1_fc2``.  Ground truth: scipy RK45
at tight tolerance.

Route on the card: the branched network takes the traversal's plain
PyTorch version (branch states recurse, concat states concatenate) and
its plain forward in ``predict``; then an L-BFGS polish.  The port of
examples/30.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/30_branched_multihead.py [--cpu]
"""

import sys

import numpy as np
from scipy.integrate import solve_ivp

from pydens_tpu_torch import Solver, D, NumpySampler


def main(device=None):
    def lotka_volterra(f, t):
        u, v = f[:, 0:1], f[:, 1:2]
        return (D(u, t) - u + u * v,
                D(v, t) + 1.5 * v - u * v)

    solver = Solver(lotka_volterra, ndims=1, seed=0, activation="Tanh",
                    layout="fa fa B f .", features=[32, 32, 1],
                    branches=[dict(layout="fa f", features=[16, 1])],
                    domain=(0.0, 2.0),
                    initial_condition=np.array([2.0, 1.0]), device=device)
    assert solver._plan_ok  # branch + concat stay on the Taylor plan
    assert "br1_fc1" in solver.model.layer_names

    sampler = NumpySampler("u", low=0.0, high=2.0, seed=0)
    solver.fit(niters=2500, batch_size=512, lr=5e-3, sampler=sampler,
               progress=False)
    solver.fit(niters=150, batch_size=2048, optimizer="LBFGS",
               resample=False, sampler=sampler, progress=False)

    ts = np.linspace(0.0, 2.0, 101)
    truth = solve_ivp(lambda t, y: [y[0] - y[0] * y[1],
                                    -1.5 * y[1] + y[0] * y[1]],
                      (0.0, 2.0), [2.0, 1.0], t_eval=ts,
                      rtol=1e-9, atol=1e-10)
    pred = solver.predict(ts)
    u_err = float(np.max(np.abs(pred[:, 0] - truth.y[0])))
    v_err = float(np.max(np.abs(pred[:, 1] - truth.y[1])))
    print(f"prey max err: {u_err:.4f}   predator max err: {v_err:.4f}")
    assert u_err < 0.05 and v_err < 0.05
    return solver, {"u_err": u_err, "v_err": v_err}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
