"""Vector-calculus convenience operators built on the ``D`` token,
counterpart of ``pydens_tpu/ops/functional.py``.

Each operator is nested ``D`` written once, so it records the same plan
taps as the nested calls (a Laplacian stays on the Taylor plan):

    def pde(f, x, y):
        return laplace(f, x, y) - 5 * torch.sin(np.pi * (x + y))
"""

from .tokens import D

__all__ = ["grad", "div", "laplace", "hessian_diag", "dt", "dn"]


def grad(f, *coords):
    """Tuple of first partials ``(D(f, x1), ..., D(f, xn))``."""
    return tuple(D(f, x) for x in coords)


def div(fs, *coords):
    """Divergence of a tuple of expressions: ``sum_k D(fs[k], x_k)``."""
    if len(fs) != len(coords):
        raise ValueError(f"divergence needs one component per coordinate, "
                         f"got {len(fs)} components and {len(coords)} coords")
    out = D(fs[0], coords[0])
    for fk, xk in zip(fs[1:], coords[1:]):
        out = out + D(fk, xk)
    return out


def laplace(f, *coords):
    """Laplacian ``sum_k d2f/dx_k2`` over the given coordinates."""
    out = D(D(f, coords[0]), coords[0])
    for x in coords[1:]:
        out = out + D(D(f, x), x)
    return out


def hessian_diag(f, *coords):
    """Tuple of pure second partials ``d2f/dx_k2``."""
    return tuple(D(D(f, x), x) for x in coords)


def dt(f, t):
    """First time derivative (alias of ``D`` for readability)."""
    return D(f, t)


def dn(f, x, order):
    """n-th derivative of ``f`` w.r.t. one coordinate."""
    out = f
    for _ in range(order):
        out = D(out, x)
    return out
