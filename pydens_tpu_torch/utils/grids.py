"""Evaluation-grid helpers, counterpart of ``pydens_tpu/utils/grids.py``
(the reference tutorials hand-roll ``cart_prod`` in every notebook); numpy
on the host."""

import numpy as np

__all__ = ["cart_prod", "uniform_grid"]


def cart_prod(*arrs):
    """Cartesian product of 1-D arrays -> ``(prod(len), n_arrays)`` points."""
    grids = np.meshgrid(*arrs, indexing="ij")
    return np.stack(grids, axis=-1).reshape(-1, len(arrs))


def uniform_grid(domain, num):
    """Uniform evaluation grid over a rectangular domain.

    Parameters
    ----------
    domain : sequence of (lo, hi)
        One interval per dimension (same format as ``Solver``'s ``domain``).
    num : int or sequence of int
        Points per dimension.

    Returns
    -------
    np.ndarray of shape ``(prod(num), ndims)``
    """
    if isinstance(domain[0], (int, float)):
        domain = [domain]
    if isinstance(num, int):
        num = [num] * len(domain)
    axes = [np.linspace(lo, hi, n) for (lo, hi), n in zip(domain, num)]
    return cart_prod(*axes)
