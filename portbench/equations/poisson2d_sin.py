"""The README's Poisson equation in the program's own spelling (``D``
tokens), handed to ``pydens_tpu_torch.Solver`` as its ``equation``."""

import numpy as np
import torch


def build():
    """The equation callable ``pde(f, x, y)``; imports the program."""
    from pydens_tpu_torch import D

    def pde(f, x, y):
        return D(D(f, x), x) + D(D(f, y), y) - 5 * torch.sin(np.pi * (x + y))
    return pde
