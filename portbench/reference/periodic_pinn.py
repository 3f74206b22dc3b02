"""The plain reference of a layout-chain PINN with a periodic input
embedding and an initial condition bound by the gate, in float32 PyTorch.

Written from the configuration file and the published method, with no
kernel, plan, Taylor traversal or graph, and importing nothing of the
program under test: each periodic column ``x`` enters the network as
``sin, cos (k 2 pi (x - lo) / (hi - lo))``, ``k = 1..m``, in the column's
place (the other columns as they are), the network is dense layers and
activations, the solution is ``(sigmoid((t - t0) / exp(log_scale)) - 0.5)
net + ic(x)`` with ``t`` the last column and ``t0`` its lower bound, its
derivatives are nested ``torch.autograd.grad``, the loss is the sum over
the equation's residuals of their mean square, and Adam is
``optax.adam``'s update with its float32 bias corrections.

Parameters are one flat float32 vector, its leaves in sorted path order
(``log_scale``, ``net/fc1/b``, ``net/fc1/w``, ...); :func:`leaf_layout`
lists them.  ``log_scale`` scales the gate and is trained.
"""

import importlib
import math

import torch

ACTIVATIONS = {"Tanh": torch.tanh, "Sigmoid": torch.sigmoid}

# optax.adam's defaults.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def periodic(config):
    """``{column: harmonics}`` of the periodic columns."""
    return {int(d): int(m) for d, m in config["periodic"].items()}


def embed_width(config):
    """Columns the network takes: two a harmonic of a periodic column, one
    for every other column."""
    harm = periodic(config)
    return sum(2 * harm[i] if i in harm else 1
               for i in range(config["ndims"]))


def dense_shapes(config):
    """``[(fan_in, fan_out), ...]`` of the chain's dense layers."""
    fans = [embed_width(config)] + list(config["units"])
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


def embed(config, x):
    """The network's input columns from ``x`` ``(N, ndims)``."""
    harm = periodic(config)
    cols = []
    for i, (lo, hi) in enumerate(config["domain"]):
        xi = x[:, i:i + 1]
        if i not in harm:
            cols.append(xi)
            continue
        phase = (2.0 * math.pi / (hi - lo)) * (xi - lo)
        for k in range(1, harm[i] + 1):
            cols += [torch.sin(k * phase), torch.cos(k * phase)]
    return torch.cat(cols, dim=1)


def network(config, theta, x):
    """The layout chain on the embedded ``x``: ``f`` a dense layer, ``a``
    the activation."""
    p = unflatten(config, theta)
    act = ACTIVATIONS[config["activation"]]
    h, layer = embed(config, x), 0
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


def equation(config):
    return importlib.import_module(
        f"portbench.reference.equations.{config['equation']}")


def solution(config, theta, x):
    """The gate ansatz that binds the initial condition exactly at ``t0``
    for all ``t`` (no decay): ``(sigmoid((t - t0) / exp(log_scale)) -
    0.5) net(x) + ic(x)``."""
    u = network(config, theta, x)
    t = x[:, -1:]
    t0 = config["domain"][-1][0]
    log_scale = unflatten(config, theta)[("log_scale",)]
    gate = torch.sigmoid((t - t0) / torch.exp(log_scale)) - 0.5
    return gate * u + equation(config).initial_condition(x[:, :-1])


def residual(config, theta, pts):
    """The equation's residuals, a list of ``(N, 1)`` columns, each output
    component's derivatives by nested autograd; differentiable in
    ``theta``."""
    eq = equation(config)
    with torch.enable_grad():
        x = pts.detach().clone().requires_grad_(True)
        u = solution(config, theta, x)
        d = {(): u}
        for mi in sorted({m[:k] for m in eq.DERIVATIVES
                          for k in range(1, len(m) + 1)}, key=len):
            parent = d[mi[:-1]]
            d[mi] = torch.cat([
                torch.autograd.grad(parent[:, c].sum(), x,
                                    create_graph=True)[0][:, mi[-1]:mi[-1]
                                                          + 1]
                for c in range(u.shape[1])], dim=1)
        cols = [x[:, i:i + 1] for i in range(config["ndims"])]
        return eq.residual(d, *cols)


def loss(config, theta, pts):
    """The sum over the residuals of their mean square (``MSELoss``
    against zero, one term a residual)."""
    return sum(torch.mean(r ** 2) for r in residual(config, theta, pts))


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


def predict(config, theta, pts, block=1 << 16):
    """The solution at ``pts``, in blocks of rows."""
    with torch.no_grad():
        return torch.cat([solution(config, theta, pts[i:i + block])
                          for i in range(0, pts.shape[0], block)])
