"""Residual-based adaptive collocation on a stiff problem, on
pydens_tpu_torch: a source bump of width ~0.02 that uniform sampling
underresolves.  `fit(adaptive=8)` draws 8x candidates per iteration and
importance-samples half the batch proportionally to |residual| (with
unbiased weights).

Route on the card: the fused Taylor kernels; an adaptive step launches
the forward twice (the candidate pool's residual, then the batch) and
the backward once, a uniform step each once.  The port of examples/09.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/09_adaptive_collocation.py [--cpu]
"""

import sys

import numpy as np

import pydens_tpu_torch as pdt
from pydens_tpu_torch import Solver, D


def make_solver(device=None):
    def ode(f, x):
        return D(f, x) - 100 * pdt.exp(-2000 * (x - 0.8) ** 2)

    return Solver(ode, ndims=1, initial_condition=0.0, activation="Tanh",
                  layout="fafaf", features=[32, 32, 1], seed=0,
                  device=device)


def main(device=None):
    xs = np.linspace(0, 1, 2000)

    uniform = make_solver(device)
    uniform.fit(niters=1500, batch_size=128, lr=0.01)
    res_uniform = float(uniform.residual(xs).mean())

    adaptive = make_solver(device)
    adaptive.fit(niters=1500, batch_size=128, lr=0.01, adaptive=8)
    res_adaptive = float(adaptive.residual(xs).mean())

    print(f"mean |residual| uniform:  {res_uniform:.4f}")
    print(f"mean |residual| adaptive: {res_adaptive:.4f} "
          f"({res_uniform / res_adaptive:.1f}x better)")
    assert res_adaptive < res_uniform * 0.6, (res_adaptive, res_uniform)
    return adaptive, {"res_uniform": res_uniform,
                      "res_adaptive": res_adaptive,
                      "ratio": res_adaptive / res_uniform}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
