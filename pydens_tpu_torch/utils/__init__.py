"""Runtime utilities: criteria and optimizers."""

from .criteria import resolve_criterion
from .optimizers import resolve_optimizer

__all__ = ["resolve_criterion", "resolve_optimizer"]
