"""The nonlinear Schrodinger equation of Raissi et al. (2019, sec. 3.1.1)
in the program's own spelling (``D`` tokens), as examples_torch/15 states
it: ``h = u + i v``, the real and imaginary parts of ``i h_t + 0.5 h_xx +
|h|^2 h = 0``, and the initial condition ``h(x, 0) = 2 sech(x)``."""

import torch


def build():
    """The equation callable ``nls(f, x, t)``; imports the program."""
    from pydens_tpu_torch import D

    def nls(f, x, t):
        u, v = f[:, 0:1], f[:, 1:2]
        mag2 = u * u + v * v
        return (D(u, t) + 0.5 * D(D(v, x), x) + mag2 * v,
                -D(v, t) + 0.5 * D(D(u, x), x) + mag2 * u)
    return nls


def initial_condition(x):
    """``(2 sech x, 0)`` at the spatial column ``x``."""
    return torch.stack([2.0 / torch.cosh(x), torch.zeros_like(x)], dim=-1)
