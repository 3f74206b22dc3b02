"""Runtime utilities: criteria, optimizers and evaluation grids."""

from .criteria import resolve_criterion
from .optimizers import resolve_optimizer
from .grids import cart_prod, uniform_grid

__all__ = ["resolve_criterion", "resolve_optimizer", "cart_prod",
           "uniform_grid"]
