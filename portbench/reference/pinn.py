"""The plain reference of a layout-chain PINN, in float32 PyTorch.

Written from the configuration file and the published method, with no
kernel, plan, Taylor traversal or graph: the network is dense layers and
activations, its derivatives are nested ``torch.autograd.grad``, the loss
is the mean squared residual, Adam is ``optax.adam``'s update, and
Levenberg-Marquardt is the damped Gauss-Newton step solved by conjugate
gradients as ``jax.scipy.sparse.linalg.cg`` stops it, with Nielsen's gain
ratio damping.  It imports nothing of the program under test.

Parameters are one flat float32 vector, its leaves in sorted path order
(``log_scale``, ``net/fc1/b``, ``net/fc1/w``, ...); :func:`leaf_layout`
lists them.  ``log_scale`` scales an initial condition's gate and has no
use in a boundary-value problem: its gradient is exactly zero.
"""

import importlib
import math

import torch

ACTIVATIONS = {"Tanh": torch.tanh, "Sigmoid": torch.sigmoid}

# optax.adam's defaults.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def dense_shapes(config):
    """``[(fan_in, fan_out), ...]`` of the chain's dense layers."""
    fans = [config["ndims"]] + list(config["units"])
    return list(zip(fans[:-1], fans[1:]))


def leaf_layout(config):
    """``[(path, shape), ...]`` of the parameter leaves in flat order."""
    leaves = [(("log_scale",), ())]
    for i, (fan_in, fan_out) in enumerate(dense_shapes(config), 1):
        leaves.append((("net", f"fc{i}", "w"), (fan_in, fan_out)))
        leaves.append((("net", f"fc{i}", "b"), (fan_out,)))
    return sorted(leaves)


def init_bounds(config, device):
    """Each flat entry's init half-width: ``1/sqrt(fan_in)`` for a dense
    layer's weights and bias (``torch.nn.Linear``'s default), 0 for
    ``log_scale``."""
    fan_of = {f"fc{i}": fan_in for i, (fan_in, _)
              in enumerate(dense_shapes(config), 1)}
    parts = []
    for path, shape in leaf_layout(config):
        bound = 0.0 if path[0] == "log_scale" else fan_of[path[1]] ** -0.5
        parts.append(torch.full((math.prod(shape),), bound,
                                dtype=torch.float32, device=device))
    return torch.cat(parts)


def unflatten(config, theta):
    """``{path: view}`` of a flat ``theta``."""
    out, start = {}, 0
    for path, shape in leaf_layout(config):
        size = math.prod(shape)
        out[path] = theta[start:start + size].view(shape)
        start += size
    return out


def leaves(config, theta):
    """The leaves of ``theta`` as a list, in flat order."""
    return list(unflatten(config, theta).values())


def network(config, theta, x):
    """The layout chain on ``x`` ``(N, ndims)``: ``f`` a dense layer, ``a``
    the activation."""
    p = unflatten(config, theta)
    act = ACTIVATIONS[config["activation"]]
    h, layer = x, 0
    for token in config["layout"].replace(" ", ""):
        if token == "f":
            layer += 1
            h = h @ p[("net", f"fc{layer}", "w")] + p[("net", f"fc{layer}",
                                                       "b")]
        elif token == "a":
            h = act(h)
        else:
            raise ValueError(f"layout token {token!r} has no reference")
    return h


def solution(config, theta, x):
    """The ansatz that binds the Dirichlet condition exactly: ``net(x)
    prod_i (x_i - lo_i)(hi_i - x_i) / (hi_i - lo_i)^2 + bc``."""
    u = network(config, theta, x)
    shape = None
    for i, (lo, hi) in enumerate(config["domain"]):
        xi = x[:, i:i + 1]
        term = (xi - lo) * (hi - xi) / ((hi - lo) * (hi - lo))
        shape = term if shape is None else shape * term
    return u * shape + config["boundary_condition"]


def equation(config):
    return importlib.import_module(
        f"portbench.reference.equations.{config['equation']}")


def residual(config, theta, pts):
    """The equation's residual ``(N, 1)`` at the points, its derivatives by
    nested autograd; differentiable in ``theta``."""
    eq = equation(config)
    with torch.enable_grad():
        x = pts.detach().clone().requires_grad_(True)
        u = solution(config, theta, x)
        d, grads = {(): u}, {}
        for mi in sorted({m[:k] for m in eq.DERIVATIVES
                          for k in range(1, len(m) + 1)}, key=len):
            parent = mi[:-1]
            if parent not in grads:
                grads[parent], = torch.autograd.grad(d[parent].sum(), x,
                                                     create_graph=True)
            d[mi] = grads[parent][:, mi[-1]:mi[-1] + 1]
        cols = [x[:, i:i + 1] for i in range(config["ndims"])]
        return eq.residual(d, *cols)


def loss(config, theta, pts):
    """The MSE of the residual (``MSELoss`` against zero)."""
    return torch.mean(residual(config, theta, pts) ** 2)


def value_and_grad(config, theta, pts):
    t = theta.detach().requires_grad_(True)
    value = loss(config, t, pts)
    grad, = torch.autograd.grad(value, t)
    return value.detach(), grad


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def adam_steps(config, theta, batches, lr):
    """``len(batches)`` Adam steps from ``theta``, one batch each.
    Returns ``(losses before each step, first gradient, theta after)``."""
    theta = theta.detach().clone()
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    losses, first = [], None
    for count, pts in enumerate(batches, 1):
        value, grad = value_and_grad(config, theta, pts)
        losses.append(float(value))
        first = grad if first is None else first
        mu = (1 - ADAM_B1) * grad + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * grad * grad + ADAM_B2 * nu
        # optax evaluates the bias corrections in float32.
        mu_hat = mu / (1 - _f32(ADAM_B1) ** count)
        nu_hat = nu / (1 - _f32(ADAM_B2) ** count)
        theta = theta - lr * mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
    return losses, first, theta


def predict(config, theta, pts, block=1 << 18):
    """The solution at ``pts``, in blocks of rows."""
    with torch.no_grad():
        return torch.cat([solution(config, theta, pts[i:i + block])
                          for i in range(0, pts.shape[0], block)])


# ---------------------------------------------------------------------------
# Levenberg-Marquardt
# ---------------------------------------------------------------------------

# The finisher's defaults: (lambda, nu) start at (1e-3, 2); a step that
# lowers the loss shrinks lambda by max(1 - (2 rho - 1)^3, 1/3) and resets
# nu to 2, one that does not multiplies lambda by nu and doubles nu.
LM_DEFAULTS = dict(cg_tol=1e-6, init_damping=1e-3, damping_down=1.0 / 3.0,
                   damping_up=2.0, min_damping=1e-12, max_damping=1e12)


class Linearized:
    """``r``, ``J v`` and ``J^T w`` of the residual vector at ``theta``
    (``r . r`` is the loss; ``J^T r`` is ``vjp(r)``): reverse mode twice,
    ``J v`` as the derivative of ``J^T u`` in ``u``."""

    def __init__(self, config, theta, pts):
        self.theta = theta.detach().requires_grad_(True)
        n = pts.shape[0]
        self.r = residual(config, self.theta, pts)[:, 0] / math.sqrt(n)
        self.u = torch.zeros_like(self.r, requires_grad=True)
        self.jtu, = torch.autograd.grad(self.r, self.theta, self.u,
                                        create_graph=True)

    def jvp(self, v):
        return torch.autograd.grad(self.jtu, self.u, v, retain_graph=True)[0]

    def vjp(self, w):
        return torch.autograd.grad(self.r, self.theta, w,
                                   retain_graph=True)[0]


def lm_products(config, theta, pts, v, w):
    """The products one LM step of the program makes first, worked out
    again at ``theta`` on ``pts``: ``J^T r``, ``J v`` and ``J^T w``."""
    lin = Linearized(config, theta, pts)
    return (lin.vjp(lin.r.detach()).detach(), lin.jvp(v).detach(),
            lin.vjp(w).detach())


def lm_step(config, theta, pts, damping, cg_iters):
    """One damped Gauss-Newton step.  Returns ``(loss at theta, J^T r, new
    theta, new (lambda, nu), live CG iterations)``."""
    o = LM_DEFAULTS
    lam, nu = damping
    lin = Linearized(config, theta, pts)
    r = lin.r.detach()
    value = float(r @ r)
    b = lin.vjp(lin.r.detach())
    with torch.no_grad():
        x = torch.zeros_like(b)
        res, p = b.clone(), b.clone()
        gamma = res @ res
        floor = max(o["cg_tol"] ** 2 * float(b @ b), 0.0)
    live = 0
    for _ in range(cg_iters):
        if not float(gamma) > floor:
            break
        live += 1
        ap = lin.vjp(lin.jvp(p)).detach() + lam * p
        with torch.no_grad():
            alpha = gamma / (p @ ap)
            x = x + alpha * p
            res_new = res - alpha * ap
            gamma_new = res_new @ res_new
            p = res_new + (gamma_new / gamma) * p
            res, gamma = res_new, gamma_new
    del lin
    with torch.no_grad():
        trial = theta.detach() - x
        r_t = residual(config, trial, pts)[:, 0].detach() / math.sqrt(
            pts.shape[0])
        loss_t = float(r_t @ r_t)
        actual = value - loss_t
        pred = float(x @ (lam * x + b))
        rho = actual / max(pred, 1e-30)
        if math.isfinite(loss_t) and actual > 0:
            t = 2.0 * rho - 1.0
            shrink = max(1.0 - t * t * t, o["damping_down"])
            new_damping = (max(lam * shrink, o["min_damping"]),
                           o["damping_up"])
            new_theta = trial
        else:
            new_damping = (min(lam * nu, o["max_damping"]),
                           min(nu * 2.0, 1e6))
            new_theta = theta.detach().clone()
    return value, b.detach(), new_theta, new_damping, live


def lm_steps(config, theta, batches, cg_iters):
    """``len(batches)`` LM steps from ``theta`` (the optimizer's initial
    damping), one point set each.  Returns ``(losses before each step,
    J^T r at theta, theta after each step, live CG iterations of each)``."""
    damping = (LM_DEFAULTS["init_damping"], LM_DEFAULTS["damping_up"])
    losses, first_grad, thetas, lives = [], None, [], []
    theta = theta.detach().clone()
    for pts in batches:
        value, grad, theta, damping, live = lm_step(config, theta, pts,
                                                    damping, cg_iters)
        losses.append(value)
        thetas.append(theta)
        lives.append(live)
        first_grad = grad if first_grad is None else first_grad
    return losses, first_grad, thetas, lives
