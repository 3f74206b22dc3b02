"""Systems of coupled equations on pydens_tpu_torch: the harmonic
oscillator as a first-order system with an exactly-bound vector initial
condition.

    u' = v,   v' = -omega^2 u,   u(0) = 0, v(0) = omega
    =>  u = sin(omega x),  v = omega cos(omega x)

Route on the card: the two-output chain takes the fused Taylor kernels on
every Adam and L-BFGS step; ``predict`` runs the fused MLP kernel.  The
port of examples/07.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/07_system_of_equations.py [--cpu]
"""

import sys

import numpy as np

from pydens_tpu_torch import Solver, D


def main(device=None):
    omega = 2 * np.pi

    def oscillator(f, x):
        u, v = f[:, 0:1], f[:, 1:2]
        return (D(u, x) - v, D(v, x) + omega ** 2 * u)

    solver = Solver(oscillator, ndims=1, seed=0, activation="Tanh",
                    layout="fa fa f", features=[32, 32, 2],
                    initial_condition=np.array([0.0, omega]), device=device)
    solver.fit(niters=2000, batch_size=512, lr=0.01)
    solver.fit(niters=150, batch_size=2048, optimizer="LBFGS",
               resample=False)

    xs = np.linspace(0, 1, 100)
    pred = solver.predict(xs)
    u_err = float(np.max(np.abs(pred[:, 0] - np.sin(omega * xs))))
    v_err = float(np.max(np.abs(pred[:, 1] - omega * np.cos(omega * xs))))
    print(f"u max err: {u_err:.4f}   v max err: {v_err:.4f}")
    print(f"IC at x=0: {solver.predict(0.0).ravel()} (true: [0, {omega:.3f}])")
    assert u_err < 0.15 and v_err < 0.15 * omega
    return solver, {"u_err": u_err, "v_err": v_err}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
