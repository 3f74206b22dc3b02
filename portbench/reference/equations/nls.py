"""The nonlinear Schrodinger equation ``i h_t + 0.5 h_xx + |h|^2 h = 0`` as
a real system in ``h = u + i v`` (Raissi et al. 2019, sec. 3.1.1), and its
initial condition ``h(x, 0) = 2 sech(x)``, for the plain reference."""

import torch

# Multi-indices of the derivatives of (u, v) the residuals read: h_t, h_xx.
DERIVATIVES = ((1,), (0, 0))


def residual(d, x, t):
    """``[u_t + 0.5 v_xx + (u^2 + v^2) v, -v_t + 0.5 u_xx + (u^2 + v^2)
    u]``; ``d`` maps a multi-index to the derivative's ``(N, 2)``
    columns (u, v)."""
    u, v = d[()][:, 0:1], d[()][:, 1:2]
    mag2 = u * u + v * v
    return [d[(1,)][:, 0:1] + 0.5 * d[(0, 0)][:, 1:2] + mag2 * v,
            -d[(1,)][:, 1:2] + 0.5 * d[(0, 0)][:, 0:1] + mag2 * u]


def initial_condition(x):
    """``(2 sech x, 0)`` at the spatial columns ``x`` ``(N, 1)``."""
    return torch.cat([2.0 / torch.cosh(x), torch.zeros_like(x)], dim=1)
