"""Layer-wise adaptive activations (L-LAAF) as a drop-in convergence
accelerant on a smooth problem, on pydens_tpu_torch.

The reference README's 2D Poisson:

    u_xx + u_yy = 5 sin(pi (x + y)),   u = 1 on the boundary (exact ansatz)

with ``adaptive_activation=10``: every activation slot gets ONE trainable
slope ``a_i`` applied as ``tanh(10 * a_i * h)``, ``a_i`` init ``0.1`` so
training starts at the plain network (Jagtap/Kawaguchi/Karniadakis, arXiv
1909.12228).  The slope is a linear pre-scale, so the single-traversal
Taylor derivative plan stays exact and on.

Route on the card: the slopes take the network off the fused kernels —
the traversal's plain PyTorch version in training and the plain forward
in ``predict``.  The port of examples/32.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/32_adaptive_activation.py [--cpu]
"""

import sys

import numpy as np
import torch

from pydens_tpu_torch import D, Solver

# Plain-arm median at this budget, measured over 3 seeds in
# benchmarks/bench_laaf_ab.py; the assert pins the LAAF run BELOW it.
PLAIN_MEDIAN_LOSS = 1.7e-3


def main(device=None):
    def poisson(f, x, y):
        return (D(D(f, x), x) + D(D(f, y), y)
                + 5.0 * torch.sin(np.pi * (x + y)))

    solver = Solver(poisson, ndims=2, boundary_condition=1, seed=0,
                    layout="fa fa fa f", features=[10, 12, 15, 1],
                    activation="Tanh", adaptive_activation=10.0,
                    device=device)
    assert solver._plan_ok  # the slope pre-scale keeps the Taylor plan on

    solver.fit(niters=1500, batch_size=100, lr=5e-3, progress=False)
    loss = float(solver.losses[-1])
    slopes = {nm: round(10.0 * float(v["a"].detach().cpu()[0]), 3)
              for nm, v in solver.model.params["net"].items()
              if nm.startswith("aa")}
    print(f"final residual loss: {loss:.2e} "
          f"(plain-net median at this budget: {PLAIN_MEDIAN_LOSS:.1e})")
    print(f"trained effective slopes n*a: {slopes}")

    # Assert with ~4x slack but still well below the plain net's median —
    # the accelerant must actually help.
    assert loss < 6e-4, loss
    # The exact-BC ansatz is untouched by the slopes.
    edge = solver.predict(np.zeros(33), np.linspace(0, 1, 33))
    edge_err = float(np.abs(edge - 1.0).max())
    assert np.allclose(edge, 1.0, atol=1e-5)
    # Slopes trained away from init (they carry gradient).
    assert any(abs(s - 1.0) > 0.01 for s in slopes.values()), slopes
    return solver, {"loss": loss, "edge_err": edge_err, "slopes": slopes}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
