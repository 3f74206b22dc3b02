"""Optimizer registry, counterpart of ``pydens_tpu/utils/optimizers.py``.

Ported so far: Adam, with torch-style ``betas`` and ``eps`` and the update
of ``optax.adam`` (bias-corrected moments, ``eps`` outside the square
root), applied in place to the Solver's ONE flat parameter vector with no
host synchronisation.  The other names of the JAX registry are scheduled
in ROADMAP.md (Queue 1 item 9).
"""

import warnings

import torch

__all__ = ["Adam", "resolve_optimizer"]


class Adam:
    """``optax.adam`` on a flat float tensor, in place: ``init`` builds the
    state (first and second moments, step count, all on the device) and
    ``update`` applies one step to ``theta``."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        self.lr = float(learning_rate)
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.eps = float(eps)

    def init(self, theta):
        return {"mu": torch.zeros_like(theta), "nu": torch.zeros_like(theta),
                "count": torch.zeros((), dtype=theta.dtype,
                                     device=theta.device)}

    @torch.no_grad()
    def update(self, theta, grad, state, gate=None):
        """One step, in place.  ``gate``, a 0-d bool device tensor, makes
        the step a no-op on ``theta`` and the state where it is False, with
        no host read (the Solver's divergence guard)."""
        b1, b2 = self.b1, self.b2
        if gate is None:
            count = state["count"].add_(1.0)
            mu = state["mu"].mul_(b1).add_(grad, alpha=1.0 - b1)
            nu = state["nu"].mul_(b2).addcmul_(grad, grad, value=1.0 - b2)
        else:
            count = state["count"].add(1.0)
            mu = state["mu"].mul(b1).add_(grad, alpha=1.0 - b1)
            nu = state["nu"].mul(b2).addcmul_(grad, grad, value=1.0 - b2)
        mu_hat = mu / (1.0 - b1 ** count)
        nu_hat = nu / (1.0 - b2 ** count)
        step = self.lr * mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if gate is None:
            theta.sub_(step)
            return
        for dst, new in ((theta, theta - step), (state["mu"], mu),
                         (state["nu"], nu), (state["count"], count)):
            torch.where(gate, new, dst, out=dst)


def _adam_family(factory):
    def build(lr, kwargs):
        b1, b2 = kwargs.pop("betas", (0.9, 0.999))
        eps = kwargs.pop("eps", 1e-8)
        extra = {}
        if "weight_decay" in kwargs:
            # Passed through: Adam, like optax.adam, takes none and raises.
            extra["weight_decay"] = kwargs.pop("weight_decay")
        _warn_unused(kwargs)
        return factory(learning_rate=lr, b1=b1, b2=b2, eps=eps, **extra)
    return build


def _warn_unused(kwargs):
    if kwargs:
        warnings.warn(f"ignoring unsupported optimizer kwargs: "
                      f"{sorted(kwargs)}", stacklevel=3)


_OPTIMIZERS = {"adam": _adam_family(Adam)}

_NOT_PORTED = {"adamw", "adamax", "nadam", "radam", "sgd", "rmsprop",
               "adagrad", "adadelta", "lion", "lbfgs", "lm", "gn",
               "gaussnewton", "gauss_newton", "gauss-newton",
               "levenbergmarquardt", "levenberg_marquardt",
               "levenberg-marquardt"}


def resolve_optimizer(name, lr, kwargs):
    """Build an optimizer from a torch-style name (``'Adam'``), or pass an
    object with ``init(theta)`` and ``update(theta, grad, state,
    gate=None)`` (as :class:`Adam`) through."""
    if not isinstance(name, str):
        if hasattr(name, "init") and hasattr(name, "update"):
            return name
        raise ValueError(f"cannot interpret optimizer {name!r}")
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported to pydens_tpu_torch yet "
            "(ROADMAP.md, Queue 1 item 9); use 'Adam'")
    if key not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; "
                         f"known: {sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[key](lr, dict(kwargs))
