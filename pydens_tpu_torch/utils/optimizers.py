"""Optimizer registry, counterpart of ``pydens_tpu/utils/optimizers.py``.

The first-order optimizers of the JAX registry, each the update of its
optax 0.2.6 transform (``optax.adam``, ``adamw``, ``adamax``, ``nadam``,
``radam``, ``sgd``, ``rmsprop``, ``adagrad``, ``adadelta``, ``lion``) with
the JAX registry's torch-style names and defaults, applied in place to the
Solver's ONE flat parameter vector with no host synchronisation, so an
update runs inside a captured CUDA graph of the fit step.  The learning
rate is a float or a schedule (:mod:`pydens_tpu_torch.utils.schedules`),
evaluated at the count of updates applied before this one, as optax's
``scale_by_schedule`` does; the bias corrections use the count after it, as
``scale_by_adam`` does.  L-BFGS and Levenberg-Marquardt are ROADMAP.md
Queue 1 item 9's next slice.
"""

import warnings

import torch

__all__ = ["Adam", "AdamW", "Adamax", "NAdam", "RAdam", "SGD", "RMSprop",
           "Adagrad", "Adadelta", "Lion", "resolve_optimizer"]


def _bias_correction(moment, decay, count):
    return moment / (1 - decay ** count)


class _FlatOptimizer:
    """An optax update on a flat float tensor, in place.

    ``init(theta)`` builds the state, a dict of device tensors (``count``,
    int32, and the subclass's buffers); ``update(theta, grad, state,
    gate=None)`` applies one step.  ``gate``, a 0-d bool device tensor,
    makes the step a no-op on ``theta`` and on every state buffer where it
    is False, with no host read (the Solver's divergence guard).
    Subclasses give ``_buffers(theta)`` (name -> initial tensor) and
    ``_step(theta, grad, state, count, lr)``, which returns the change of
    ``theta`` and the new buffers without writing anything."""

    def __init__(self, learning_rate):
        self.lr = learning_rate if callable(learning_rate) else float(
            learning_rate)

    def init(self, theta):
        state = {"count": torch.zeros((), dtype=torch.int32,
                                      device=theta.device)}
        state.update(self._buffers(theta))
        return state

    def _buffers(self, theta):
        return {}

    @torch.no_grad()
    def update(self, theta, grad, state, gate=None):
        count = state["count"]
        lr = self.lr(count) if callable(self.lr) else self.lr
        count = count + 1
        delta, new = self._step(theta, grad, state, count, lr)
        new["count"] = count
        if gate is None:
            theta.add_(delta)
            for name, value in new.items():
                state[name].copy_(value)
            return
        torch.where(gate, theta + delta, theta, out=theta)
        for name, value in new.items():
            torch.where(gate, value, state[name], out=state[name])


def _moments(theta):
    return {"mu": torch.zeros_like(theta), "nu": torch.zeros_like(theta)}


class Adam(_FlatOptimizer):
    """``optax.adam``: bias-corrected moments, ``eps`` outside the square
    root; ``nesterov=True`` is ``optax.nadam``."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 nesterov=False):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.nesterov = bool(nesterov)

    _buffers = staticmethod(_moments)

    def _direction(self, grad, state, count):
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * grad + b1 * state["mu"]
        nu = (1 - b2) * (grad * grad) + b2 * state["nu"]
        if self.nesterov:
            mu_hat = (b1 * _bias_correction(mu, b1, count + 1)
                      + (1 - b1) * _bias_correction(grad, b1, count))
        else:
            mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        return mu_hat / (torch.sqrt(nu_hat) + self.eps), {"mu": mu, "nu": nu}

    def _step(self, theta, grad, state, count, lr):
        u, new = self._direction(grad, state, count)
        return -lr * u, new


class NAdam(Adam):
    """``optax.nadam``: Adam with the Nesterov first moment."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(learning_rate, b1, b2, eps, nesterov=True)


class AdamW(Adam):
    """``optax.adamw``: Adam's direction plus ``weight_decay * theta``
    (every entry, frozen ones too, as in ``pydens_tpu``)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-4):
        super().__init__(learning_rate, b1, b2, eps)
        self.weight_decay = float(weight_decay)

    def _step(self, theta, grad, state, count, lr):
        u, new = self._direction(grad, state, count)
        return -lr * (u + self.weight_decay * theta), new


class Adamax(Adam):
    """``optax.adamax``: the infinity norm in place of the second moment."""

    def _step(self, theta, grad, state, count, lr):
        b1 = self.b1
        mu = (1 - b1) * grad + b1 * state["mu"]
        nu = torch.maximum(torch.abs(grad) + self.eps, self.b2 * state["nu"])
        return -lr * (_bias_correction(mu, b1, count) / nu), {"mu": mu,
                                                              "nu": nu}


class RAdam(Adam):
    """``optax.radam``: Adam rectified by the variance of its adaptive
    rate; plain momentum while the rectifier's ``ro`` is below
    ``threshold``."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 threshold=5.0):
        super().__init__(learning_rate, b1, b2, eps)
        self.threshold = float(threshold)

    def _step(self, theta, grad, state, count, lr):
        b1, b2 = self.b1, self.b2
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        mu = (1 - b1) * grad + b1 * state["mu"]
        nu = (1 - b2) * (grad * grad) + b2 * state["nu"]
        b2t = b2 ** count
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                       / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        u = torch.where(ro >= self.threshold,
                        r * mu_hat / (torch.sqrt(nu_hat) + self.eps), mu_hat)
        return -lr * u, {"mu": mu, "nu": nu}


def _trace(update, trace, decay, nesterov):
    """``optax.trace``: ``(output, new trace)``."""
    new = update + decay * trace
    return (update + decay * new if nesterov else new), new


class SGD(_FlatOptimizer):
    """``optax.sgd``: with ``momentum`` (None for none) the trace of the
    gradients, Nesterov's with ``nesterov=True``, then the learning rate."""

    def __init__(self, learning_rate, momentum=None, nesterov=False):
        super().__init__(learning_rate)
        self.momentum = None if momentum is None else float(momentum)
        self.nesterov = bool(nesterov)

    def _buffers(self, theta):
        return {} if self.momentum is None else {
            "trace": torch.zeros_like(theta)}

    def _step(self, theta, grad, state, count, lr):
        if self.momentum is None:
            return -lr * grad, {}
        u, trace = _trace(grad, state["trace"], self.momentum, self.nesterov)
        return -lr * u, {"trace": trace}


class RMSprop(_FlatOptimizer):
    """``optax.rmsprop``: the gradient over the root of its mean square
    (``eps`` inside the root; ``centered`` subtracts the squared mean),
    then the learning rate, then with ``momentum`` (None for none) the
    trace of the scaled updates."""

    def __init__(self, learning_rate, decay=0.9, eps=1e-8, centered=False,
                 momentum=None, nesterov=False):
        super().__init__(learning_rate)
        self.decay, self.eps = float(decay), float(eps)
        self.centered = bool(centered)
        self.momentum = None if momentum is None else float(momentum)
        self.nesterov = bool(nesterov)

    def _buffers(self, theta):
        state = {"nu": torch.zeros_like(theta)}
        if self.centered:
            state["mu"] = torch.zeros_like(theta)
        if self.momentum is not None:
            state["trace"] = torch.zeros_like(theta)
        return state

    def _step(self, theta, grad, state, count, lr):
        d = self.decay
        new = {"nu": (1 - d) * (grad * grad) + d * state["nu"]}
        if self.centered:
            new["mu"] = (1 - d) * grad + d * state["mu"]
            scaling = torch.rsqrt(new["nu"] - new["mu"] * new["mu"]
                                  + self.eps)
        else:
            scaling = torch.rsqrt(new["nu"] + self.eps)
        delta = -lr * (scaling * grad)
        if self.momentum is not None:
            delta, new["trace"] = _trace(delta, state["trace"],
                                         self.momentum, self.nesterov)
        return delta, new


class Adagrad(_FlatOptimizer):
    """``optax.adagrad``: the gradient over the root of the sum of its
    squares, started at ``initial_accumulator_value``."""

    def __init__(self, learning_rate, initial_accumulator_value=0.1,
                 eps=1e-7):
        super().__init__(learning_rate)
        self.initial_accumulator_value = float(initial_accumulator_value)
        self.eps = float(eps)

    def _buffers(self, theta):
        return {"sum_of_squares": torch.full_like(
            theta, self.initial_accumulator_value)}

    def _step(self, theta, grad, state, count, lr):
        sos = grad * grad + state["sum_of_squares"]
        inv = torch.where(sos > 0, torch.rsqrt(sos + self.eps), 0.0)
        return -lr * (inv * grad), {"sum_of_squares": sos}


class Adadelta(_FlatOptimizer):
    """``optax.adadelta``: the gradient scaled by the ratio of the roots of
    the mean squared update and the mean squared gradient, then the
    learning rate."""

    def __init__(self, learning_rate, rho=0.9, eps=1e-6):
        super().__init__(learning_rate)
        self.rho, self.eps = float(rho), float(eps)

    def _buffers(self, theta):
        return {"e_g": torch.zeros_like(theta), "e_x": torch.zeros_like(theta)}

    def _step(self, theta, grad, state, count, lr):
        rho, eps = self.rho, self.eps
        e_g = (1 - rho) * (grad * grad) + rho * state["e_g"]
        u = (torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps)) * grad
        e_x = (1 - rho) * (u * u) + rho * state["e_x"]
        return -lr * u, {"e_g": e_g, "e_x": e_x}


class Lion(_FlatOptimizer):
    """``optax.lion``: the sign of an interpolated momentum plus
    ``weight_decay * theta``, then the learning rate."""

    def __init__(self, learning_rate, b1=0.9, b2=0.99, weight_decay=1e-3):
        super().__init__(learning_rate)
        self.b1, self.b2 = float(b1), float(b2)
        self.weight_decay = float(weight_decay)

    def _buffers(self, theta):
        return {"mu": torch.zeros_like(theta)}

    def _step(self, theta, grad, state, count, lr):
        b1, b2 = self.b1, self.b2
        u = torch.sign((1.0 - b1) * grad + b1 * state["mu"])
        mu = (1 - b2) * grad + b2 * state["mu"]
        return -lr * (u + self.weight_decay * theta), {"mu": mu}


def _warn_unused(kwargs):
    if kwargs:
        warnings.warn(f"ignoring unsupported optimizer kwargs: "
                      f"{sorted(kwargs)}", stacklevel=3)


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


def _sgd(lr, kwargs):
    momentum = kwargs.pop("momentum", 0.0) or None
    nesterov = kwargs.pop("nesterov", False)
    _warn_unused(kwargs)
    return SGD(lr, momentum=momentum, nesterov=nesterov)


def _rmsprop(lr, kwargs):
    alpha = kwargs.pop("alpha", 0.99)
    eps = kwargs.pop("eps", 1e-8)
    momentum = kwargs.pop("momentum", 0.0)
    centered = kwargs.pop("centered", False)
    _warn_unused(kwargs)
    return RMSprop(lr, decay=alpha, eps=eps, momentum=momentum,
                   centered=centered)


def _adagrad(lr, kwargs):
    eps = kwargs.pop("eps", 1e-10)
    _warn_unused(kwargs)
    return Adagrad(lr, eps=eps)


def _adadelta(lr, kwargs):
    rho = kwargs.pop("rho", 0.9)
    eps = kwargs.pop("eps", 1e-6)
    _warn_unused(kwargs)
    return Adadelta(lr, rho=rho, eps=eps)


def _lion(lr, kwargs):
    b1, b2 = kwargs.pop("betas", (0.9, 0.99))
    _warn_unused(kwargs)
    return Lion(lr, b1=b1, b2=b2)


_OPTIMIZERS = {
    "adam": _adam_family(Adam),
    "adamw": _adam_family(AdamW),
    "adamax": _adam_family(Adamax),
    "nadam": _adam_family(NAdam),
    "radam": _adam_family(RAdam),
    "sgd": _sgd,
    "rmsprop": _rmsprop,
    "adagrad": _adagrad,
    "adadelta": _adadelta,
    "lion": _lion,
}

# Second-order names of the JAX registry, the next slice of item 9: their
# line search (L-BFGS) and conjugate-gradient solve (LM) are loops whose
# length depends on the data, and LM's J.v needs a forward-mode rule
# through the fused Taylor op.
_NOT_PORTED = {"lbfgs", "lm", "gn", "gaussnewton", "gauss_newton",
               "gauss-newton", "levenbergmarquardt", "levenberg_marquardt",
               "levenberg-marquardt"}


def resolve_optimizer(name, lr, kwargs):
    """Build an optimizer from a torch-style name (``'Adam'``, ``'SGD'``,
    ...; kwargs ``betas``, ``eps``, ``momentum``, ``weight_decay``, ...),
    pass an object with ``init(theta)`` and ``update(theta, grad, state,
    gate=None)`` through, or call a factory ``f(learning_rate=lr,
    **kwargs)`` that returns one."""
    if not isinstance(name, str):
        if (not isinstance(name, type) and hasattr(name, "init")
                and hasattr(name, "update")):
            return name
        if callable(name):
            built = name(learning_rate=lr, **kwargs)
            if hasattr(built, "init") and hasattr(built, "update"):
                return built
        raise ValueError(f"cannot interpret optimizer {name!r}")
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported to pydens_tpu_torch yet: it "
            "is the next slice of ROADMAP.md Queue 1 item 9 (L-BFGS and "
            "Levenberg-Marquardt); use a first-order optimizer such as "
            "'Adam'")
    if key not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; "
                         f"known: {sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[key](lr, dict(kwargs))
