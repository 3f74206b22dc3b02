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
``scale_by_adam`` does.

Two second-order finishers take other arguments than a gradient, so the
Solver's fit step drives them itself: :class:`LBFGS` (``optax.lbfgs`` with
its zoom linesearch, :mod:`pydens_tpu_torch.utils.linesearch`) re-evaluates
the loss at trial points, and :class:`LMConfig` (matrix-free
Levenberg-Marquardt) takes ``J v`` and ``J^T u`` of the residual vector.
"""

import warnings

import torch

from .linesearch import ZoomLinesearch, col, dot, where

__all__ = ["Adam", "AdamW", "Adamax", "NAdam", "RAdam", "SGD", "RMSprop",
           "Adagrad", "Adadelta", "Lion", "LBFGS", "LMConfig", "linearize",
           "resolve_optimizer"]


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


class LBFGS:
    """``optax.lbfgs(learning_rate=None, memory_size=memory_size)`` (optax
    0.2.6): ``scale_by_lbfgs`` with the scaled initial preconditioner
    (``scale_init_precond=True``), then
    ``scale(-1)``, then ``scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy='one')``, on one flat vector, in place.

    A step is :meth:`begin` (the two-loop recursion over ``memory_size``
    ring buffers of parameter and gradient differences and their weights,
    from the value and gradient at ``theta``), then :meth:`trial` until the
    scratch's ``active`` flag is false (each trial evaluates the loss and
    its gradient once at a trial point; at most ``max_linesearch_steps``).
    The trial that ends the search moves ``theta`` to ``params + stepsize *
    updates``.  ``gate`` (a 0-d bool device tensor, as in
    :class:`_FlatOptimizer`) taken at :meth:`begin` makes the whole step a
    no-op on ``theta`` and the state where it is False.  An ensemble's
    ``(K, P)`` parameters run one L-BFGS a member (``jax.vmap`` of optax's
    update): their own memories, first-step scale and linesearch, one
    count."""

    def __init__(self, memory_size=10):
        if int(memory_size) < 1:
            raise ValueError("memory_size must be >= 1")
        self.memory_size = int(memory_size)
        self.linesearch = ZoomLinesearch()

    def init(self, theta):
        m = self.memory_size
        inf = float("inf")
        lead = tuple(theta.shape[:-1])
        count = torch.zeros((), dtype=torch.int32, device=theta.device)
        return {
            "count": count,
            "params": torch.zeros_like(theta),
            "updates": torch.zeros_like(theta),
            "diff_params_memory": theta.new_zeros((m,) + theta.shape),
            "diff_updates_memory": theta.new_zeros((m,) + theta.shape),
            "weights_memory": theta.new_zeros((m,) + lead),
            # scale_by_zoom_linesearch's state and its info.
            "learning_rate": theta.new_full(lead, 1.0),
            "value": theta.new_full(lead, inf),
            "num_linesearch_steps": torch.zeros(lead, dtype=torch.int32,
                                                device=theta.device),
            "decrease_error": theta.new_full(lead, inf),
            "curvature_error": theta.new_full(lead, inf),
        }

    def scratch(self, theta):
        """Buffers of one step: the linesearch state and the step's gate."""
        ls = self.linesearch.buffers(theta)
        ls["gate"] = torch.ones((), dtype=torch.bool, device=theta.device)
        return ls

    @torch.no_grad()
    def begin(self, theta, value, grad, state, ls, gate=None):
        """``scale_by_lbfgs``'s update at ``theta`` with gradient ``grad``,
        then the linesearch's start along ``-precond(grad)``."""
        m = self.memory_size
        count = state["count"]
        if gate is None:
            ls["gate"].fill_(True)
        else:
            ls["gate"].copy_(gate)
        gate = ls["gate"]
        started = count > 0
        diff_params = theta - state["params"]
        diff_updates = grad - state["updates"]
        vdot = dot(diff_updates, diff_params)
        weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
        diff_params = torch.where(started, diff_params, 0.0)
        diff_updates = torch.where(started, diff_updates, 0.0)
        weight = torch.where(started, weight, 0.0)
        prev = torch.remainder(count - 1, m).to(torch.int64).reshape(1)
        memories = {"diff_params_memory": diff_params,
                    "diff_updates_memory": diff_updates,
                    "weights_memory": weight}
        new = {}
        for name, row in memories.items():
            new[name] = state[name].index_copy(0, prev, row.unsqueeze(0))
        # The scaled initial preconditioner; at the first step the capped
        # reciprocal of the gradient's norm.
        numerator = dot(diff_updates, diff_params)
        denominator = dot(diff_updates, diff_updates)
        scale = torch.where(denominator > 0.0, numerator / denominator, 1.0)
        capped = torch.clamp_max(1.0 / torch.sqrt(dot(grad, grad)), 1.0)
        scale = torch.where(started, scale, capped)
        # _precondition_by_lbfgs: the two-loop recursion from memory_idx.
        order = torch.remainder(
            count + torch.arange(m, device=theta.device), m).to(torch.int64)
        dws = new["diff_params_memory"].index_select(0, order)
        dus = new["diff_updates_memory"].index_select(0, order)
        rhos = new["weights_memory"].index_select(0, order)
        vec, alphas = grad, [None] * m
        for j in reversed(range(m)):
            alphas[j] = rhos[j] * dot(dws[j], vec)
            vec = vec + col(-alphas[j]) * dus[j]
        vec = col(scale) * vec
        for j in range(m):
            beta = rhos[j] * dot(dus[j], vec)
            vec = vec + col(alphas[j] - beta) * dws[j]
        new.update(count=count + 1, params=theta, updates=grad)
        for name, t in new.items():
            torch.where(gate, t, state[name], out=state[name])
        self.linesearch.start(ls, -vec, theta, value, grad)

    def trial(self, theta, state, ls, value_and_grad):
        """One linesearch iteration; where it ends the search, ``theta``
        moves and the linesearch's state and info are kept (under the
        step's gate).  Returns the 0-d bool tensor that it was live."""
        was = self.linesearch.step(ls, value_and_grad)
        with torch.no_grad():
            commit = was & ~ls["active"] & ls["gate"]
            lr = ls["stepsize"]
            where(commit, ls["params"] + col(lr) * ls["updates"], theta,
                  out=theta)
            for name, t in (("learning_rate", lr), ("value", ls["value"]),
                            ("num_linesearch_steps", ls["count"]),
                            ("decrease_error", ls["decrease_error"]),
                            ("curvature_error", ls["curvature_error"])):
                torch.where(commit, t, state[name], out=state[name])
        return was


def linearize(residual_fn, theta):
    """``(r, J^T r, jvp, vjp)`` of ``residual_fn`` at ``theta`` (a tensor
    that requires grad): ``jvp(v) = J v`` and ``vjp(w) = J^T w`` reuse one
    graph of ``r`` and one of ``J^T u`` (the counterpart of
    ``jax.linearize`` and ``jax.linear_transpose``).  ``J^T u`` is taken at
    ``u = r`` with its graph kept; it is linear in ``u``, so its VJP with
    respect to ``u`` is ``J v``, and through the fused Taylor op that VJP
    is the tangent kernel (reverse over reverse: no forward mode)."""
    with torch.enable_grad():
        r = residual_fn(theta)
        u = r.detach().requires_grad_(True)
        jtu, = torch.autograd.grad(r, theta, u, create_graph=True)

    def jvp(v):
        return torch.autograd.grad(jtu, u, v, retain_graph=True)[0]

    def vjp(w):
        return torch.autograd.grad(r, theta, w, retain_graph=True)[0]
    return r.detach(), jtu.detach(), jvp, vjp


class LMConfig:
    """Matrix-free Levenberg-Marquardt (damped Gauss-Newton), counterpart
    of ``pydens_tpu/utils/optimizers.py``'s ``LMConfig`` with its checks.
    Per step it solves

        (J^T J + lambda I) d = J^T r,     theta <- theta - d  if
                                           |r(theta - d)|^2 < |r(theta)|^2

    by conjugate gradients from 0 (``J v`` and ``J^T u`` by autograd; no
    Jacobian is formed), with Nielsen's gain-ratio damping.  The state is
    ``{"damping": (lambda, nu)}``, for an ensemble's ``(K, P)`` parameters
    one pair a member, ``(K, 2)``: each member has its own damping, CG
    scalars, early stop and accept test (``jax.vmap`` of ``pydens_tpu``'s
    step).  :meth:`update` runs one step."""

    def __init__(self, cg_iters=50, cg_tol=1e-6, init_damping=1e-3,
                 damping_down=1.0 / 3.0, damping_up=2.0,
                 min_damping=1e-12, max_damping=1e12):
        if int(cg_iters) < 1:
            raise ValueError("cg_iters must be a positive int")
        if not (0 < damping_down < 1 < damping_up):
            raise ValueError("need 0 < damping_down < 1 < damping_up")
        self.cg_iters = int(cg_iters)
        self.cg_tol = float(cg_tol)
        self.init_damping = float(init_damping)
        self.damping_down = float(damping_down)
        self.damping_up = float(damping_up)
        self.min_damping = float(min_damping)
        self.max_damping = float(max_damping)

    def init(self, theta):
        damping = torch.tensor([self.init_damping, self.damping_up],
                               dtype=torch.float32, device=theta.device)
        return {"damping": damping.expand(tuple(theta.shape[:-1]) + (2,))
                .clone()}

    def update(self, theta, residual_fn, state, mask=None, gate=None):
        """One step in place (``gn_update`` of ``pydens_tpu/solver.py``):
        ``residual_fn(theta)`` is the residual vector ``r`` with
        ``loss == r . r``; ``mask`` (frozen entries 0) restricts the solve
        to the trainable subspace, on ``b`` and on both sides of the
        matvec.  The conjugate-gradient loop is ``jax.scipy.sparse.linalg.
        cg``'s (stop when ``r . r <= max(tol^2 b . b, 0)`` or after
        ``cg_iters``) as a fixed trip count with a device mask that freezes
        the iterate once the rule holds.  Returns ``(loss at theta, live
        CG iterations)``, 0-d device tensors; an ensemble's loss is one a
        member, and its live iterations are those where any member's CG
        runs."""
        r, jtr, jvp, vjp = linearize(residual_fn, theta)

        def matvec(v):
            if mask is not None:
                v = v * mask
            out = vjp(jvp(v))
            if mask is not None:
                out = out * mask
            return out + col(lam) * v

        with torch.no_grad():
            lam, nu = state["damping"][..., 0], state["damping"][..., 1]
            loss = dot(r, r)
            b = jtr if mask is None else jtr * mask
            x = torch.zeros_like(b)
            res, p = b, b
            gamma = dot(res, res)
            tol = torch.full((), self.cg_tol, dtype=b.dtype, device=b.device)
            floor = torch.clamp_min(tol * tol * dot(b, b), 0.0)
            live_iters = torch.zeros((), dtype=torch.int32,
                                     device=theta.device)
        for _ in range(self.cg_iters):
            Ap = matvec(p)
            with torch.no_grad():
                live = gamma > floor
                alpha = gamma / dot(p, Ap)
                x = where(live, x + col(alpha) * p, x)
                res_ = res - col(alpha) * Ap
                gamma_ = dot(res_, res_)
                p = where(live, res_ + col(gamma_ / gamma) * p, p)
                res = where(live, res_, res)
                gamma = torch.where(live, gamma_, gamma)
                live_iters = live_iters + (
                    live if live.dim() == 0 else live.any()).to(torch.int32)
        del jvp, vjp, matvec   # the graphs of the solve
        with torch.no_grad():
            trial = theta - x
        with torch.enable_grad():
            r_t = residual_fn(trial).detach()
        with torch.no_grad():
            loss_t = dot(r_t, r_t)
            actual = loss - loss_t
            pred = dot(x, col(lam) * x + b)
            rho = actual / torch.clamp_min(pred, 1e-30)
            accept = torch.isfinite(loss_t) & (actual > 0)
            t = 2.0 * rho - 1.0
            shrink = torch.clamp_min(1.0 - t * t * t, self.damping_down)
            new = torch.stack([
                torch.where(accept, torch.clamp_min(lam * shrink,
                                                    self.min_damping),
                            torch.clamp_max(lam * nu, self.max_damping)),
                torch.where(accept, self.damping_up,
                            torch.clamp_max(nu * 2.0, 1e6))], dim=-1)
            if gate is None:
                where(accept, trial, theta, out=theta)
                state["damping"].copy_(new)
            else:
                where(accept & gate, trial, theta, out=theta)
                torch.where(gate, new, state["damping"],
                            out=state["damping"])
        return loss, live_iters


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


def _lbfgs(lr, kwargs):
    memory_size = kwargs.pop("memory_size", kwargs.pop("history_size", 10))
    _warn_unused(kwargs)
    # The zoom linesearch picks the step size: a user-set lr (anything but
    # fit's 0.005 default) would be silently discarded, so say so.
    if lr is not None and lr != 0.005:
        warnings.warn(
            "optimizer='LBFGS' picks its step size with a zoom linesearch; "
            "the lr argument is ignored", stacklevel=4)
    return LBFGS(memory_size=memory_size)


def _lm(lr, kwargs):
    if lr is not None and lr != 0.005:
        warnings.warn(
            "optimizer='LM' (Gauss-Newton) solves for its own step from the "
            "damped normal equations; the lr argument is ignored",
            stacklevel=4)
    return LMConfig(**kwargs)


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
    "lbfgs": _lbfgs,
    "lm": _lm,
    "gn": _lm,
    "gaussnewton": _lm,
    "gauss_newton": _lm,
    "gauss-newton": _lm,
    "levenbergmarquardt": _lm,
    "levenberg_marquardt": _lm,
    "levenberg-marquardt": _lm,
}


def resolve_optimizer(name, lr, kwargs):
    """Build an optimizer from a torch-style name (``'Adam'``, ``'SGD'``,
    ...; kwargs ``betas``, ``eps``, ``momentum``, ``weight_decay``, ...),
    pass an object with ``init(theta)`` and ``update(theta, grad, state,
    gate=None)`` through, or call a factory ``f(learning_rate=lr,
    **kwargs)`` that returns one."""
    if not isinstance(name, str):
        if isinstance(name, (LBFGS, LMConfig)) or (
                not isinstance(name, type) and hasattr(name, "init")
                and hasattr(name, "update")):
            return name
        if callable(name):
            built = name(learning_rate=lr, **kwargs)
            if hasattr(built, "init") and hasattr(built, "update"):
                return built
        raise ValueError(f"cannot interpret optimizer {name!r}")
    key = name.lower()
    if key not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; "
                         f"known: {sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[key](lr, dict(kwargs))
