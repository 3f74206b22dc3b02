"""The README's Poisson residual for the plain reference: the derivatives
it takes and the residual from them."""

import math

import torch

# Multi-indices of the derivatives of u the residual reads.
DERIVATIVES = ((0, 0), (1, 1))


def residual(d, x, y):
    """``u_xx + u_yy - 5 sin(pi (x + y))``; ``d`` maps a multi-index to the
    derivative's ``(N, 1)`` column."""
    return d[(0, 0)] + d[(1, 1)] - 5 * torch.sin(math.pi * (x + y))
