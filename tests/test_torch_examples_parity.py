"""The equations of examples 07, 09, 12, 14-17, 21-24 and 30-32 held to
pydens_tpu at a fixed theta: each example's equation, constraints and
ansatz options at width 8 in its own layout, the JAX parameters copied
in, the loss and the theta-gradient on fixed points at the solver tests'
tolerances (loss rtol 2e-5; gradient rtol 2e-3 / atol 2e-5), and the
Taylor plan (``_plan_ok``, ``_plan_derivs``) equal to JAX's; examples/23
in both its forms (the Deep Ritz energy and the strong form).  Examples
08, 26-28 and 31's balancing: tests/test_torch_examples_options.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu.numpy as jnp_sym
import pydens_tpu_torch as tpdt
from pydens_tpu_torch.utils.criteria import mse_loss

from example_cases import assert_loss_matches, copy_params, points
from one_thread import one_thread  # noqa: F401

# Each make(pkg, m) gives an example's equation and Solver keywords at
# width 8; ``pkg`` is pydens_tpu or pydens_tpu_torch, ``m`` its math on
# symbols and arrays (pydens_tpu.numpy, the lifted jax.numpy, or torch).


def _stack(m, cols):
    return (torch.stack(cols, dim=-1) if m is torch
            else jnp.stack(cols, axis=-1))


def _target(m, a):
    """A constraint's target: a tensor in the port (a constraint subtracts
    a tensor, not a numpy array), an array in pydens_tpu."""
    return torch.from_numpy(a) if m is torch else a


def _ex07(pkg, m):
    omega = 2 * np.pi

    def oscillator(f, x):
        u, v = f[:, 0:1], f[:, 1:2]
        return (pkg.D(u, x) - v, pkg.D(v, x) + omega ** 2 * u)
    return oscillator, dict(ndims=1, activation="Tanh", layout="fa fa f",
                            features=[8, 8, 2],
                            initial_condition=np.array([0.0, omega]))


def _ex09(pkg, m):
    def ode(f, x):
        return pkg.D(f, x) - 100 * pkg.exp(-2000 * (x - 0.8) ** 2)
    return ode, dict(ndims=1, initial_condition=0.0, activation="Tanh",
                     layout="fafaf", features=[8, 8, 1])


def _ex12(pkg, m):
    left = np.array([0.0], np.float32)
    right = np.array([1.0], np.float32)

    def beam(f, x):
        return (pkg.D(pkg.D(pkg.D(pkg.D(f, x), x), x), x) - 384.0) / 384.0
    return beam, dict(ndims=1, boundary_condition=0, layout="fa fa f",
                      features=[8, 8, 1], activation="Tanh",
                      constraints=(lambda f, x: f.grad(left, wrt=0),
                                   lambda f, x: f.grad(right, wrt=0)))


def _ex14(pkg, m):
    nu, k = 0.02, 2 * np.pi
    decay = 2 * k ** 2 * nu

    def ns(f, x, y, t):
        u, v, p = f[:, 0:1], f[:, 1:2], f[:, 2:3]

        def lap(w):
            return pkg.D(pkg.D(w, x), x) + pkg.D(pkg.D(w, y), y)
        return (pkg.D(u, t) + u * pkg.D(u, x) + v * pkg.D(u, y)
                + pkg.D(p, x) - nu * lap(u),
                pkg.D(v, t) + u * pkg.D(v, x) + v * pkg.D(v, y)
                + pkg.D(p, y) - nu * lap(v),
                pkg.D(u, x) + pkg.D(v, y))

    def ic(x, y):
        return _stack(m, [-m.cos(k * x) * m.sin(k * y),
                          m.sin(k * x) * m.cos(k * y),
                          -0.25 * (m.cos(2 * k * x) + m.cos(2 * k * y))])

    def gauge(f, x, y, t):
        return f(0.25, 0.25, t)[:, 2:3] - 0.5 * pkg.exp(-2 * decay * t)
    return ns, dict(ndims=3, periodic=(0, 1), initial_condition=ic,
                    constraints=gauge, layout="fa fa fa f",
                    features=[8, 8, 8, 3], activation="Tanh")


def _ex15(pkg, m):
    def nls(f, x, t):
        hr, hi = f[:, 0:1], f[:, 1:2]
        mag2 = hr * hr + hi * hi
        return (pkg.D(hr, t) + 0.5 * pkg.D(pkg.D(hi, x), x) + mag2 * hi,
                -pkg.D(hi, t) + 0.5 * pkg.D(pkg.D(hr, x), x) + mag2 * hr)

    def ic(x):
        return _stack(m, [1.0 / m.cosh(x), m.zeros_like(x)])
    return nls, dict(ndims=2, domain=[(-5.0, 5.0), (0.0, float(np.pi / 2))],
                     periodic=(0,), initial_condition=ic,
                     periodic_ic_decay=False, layout="fa fa fa f",
                     features=[8, 8, 8, 2], activation="Tanh")


def _ex16(pkg, m):
    nu = 0.01 / np.pi

    def burgers(f, x, t):
        return pkg.D(f, t) + f * pkg.D(f, x) - nu * pkg.D(pkg.D(f, x), x)
    return burgers, dict(ndims=2, domain=[(-1.0, 1.0), (0.0, 1.0)],
                         initial_condition=lambda x: -m.sin(np.pi * x),
                         boundary_condition=0, arch="modified",
                         features=[8] * 8 + [1], activation="Tanh")


def _ex17(pkg, m):
    def pde(f, x, y, z):
        lap = (pkg.D(pkg.D(f, x), x) + pkg.D(pkg.D(f, y), y)
               + pkg.D(pkg.D(f, z), z))
        return lap + 3 * np.pi ** 2 * (m.sin(np.pi * x) * m.sin(np.pi * y)
                                       * m.sin(np.pi * z))
    return pde, dict(ndims=3, boundary_condition=0, layout="fa fa f",
                     features=[8, 8, 1], activation="Tanh")


def _ex21(pkg, m):
    kk = 8.0

    def poisson(f, x):
        return (pkg.D(pkg.D(f, x), x)
                + (2 * np.pi) ** 2 * m.sin(2 * np.pi * x)
                + 0.1 * (2 * np.pi * kk) ** 2 * m.sin(2 * np.pi * kk * x))
    return poisson, dict(ndims=1, boundary_condition=0, layout="fa fa f",
                         features=[8, 8, 1], activation="Tanh",
                         fourier_features=(32, kk))


def _ex22(pkg, m):
    rng = np.random.default_rng(0)
    obs_x = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    obs_u = _target(m, np.sin(np.pi * obs_x).astype(np.float32))
    s_field = pkg.Field("s", features=[8, 1])
    return (lambda f, x: pkg.D(pkg.D(f, x), x) - s_field(x),
            dict(ndims=1, boundary_condition=0, layout="fa fa f",
                 features=[8, 8, 1], activation="Tanh",
                 constraints=lambda f, x: f(obs_x) - obs_u))


def _ex23(form):
    def build(pkg, m):
        source = pkg.lift(lambda z: m.sign(0.5 - z))
        common = dict(ndims=1, boundary_condition=0, layout="fa fa f",
                      features=[8, 8, 1], activation="Tanh")
        if form == "variational":
            return (lambda f, x: 0.5 * pkg.D(f, x) ** 2 - source(x) * f,
                    dict(common, formulation="variational"))
        return lambda f, x: pkg.D(pkg.D(f, x), x) + source(x), common
    return build


def _lshape_boundary(n):
    """examples/24's arc-length-uniform points on the L's six segments."""
    t = (np.arange(n) + 0.5) / n * 8.0
    pts = np.zeros((n, 2))
    seg = [((0, 1), lambda s: np.c_[s, 0 * s]),
           ((1, 2), lambda s: np.c_[1 + 0 * s, s - 1]),
           ((2, 4), lambda s: np.c_[3 - s, 1 + 0 * s]),
           ((4, 6), lambda s: np.c_[-1 + 0 * s, 5 - s]),
           ((6, 7), lambda s: np.c_[s - 7, -1 + 0 * s]),
           ((7, 8), lambda s: np.c_[0 * s, s - 8])]
    for (lo, hi), fn in seg:
        sel = (t >= lo) & (t < hi)
        pts[sel] = fn(t[sel])
    return pts.astype(np.float32)


def _ex24(pkg, m):
    bp = _lshape_boundary(512)
    r = np.sqrt(bp[:, 0] ** 2 + bp[:, 1] ** 2)
    th = np.mod(np.arctan2(bp[:, 1], bp[:, 0]), 2 * np.pi)
    gb = _target(m, ((r ** (2 / 3)) * np.sin(2 * th / 3)).reshape(
        -1, 1).astype(np.float32))
    return (lambda f, x, y: pkg.laplace(f, x, y),
            dict(ndims=2, domain=[(-1, 1), (-1, 1)], layout="fa fa fa f",
                 features=[8, 8, 8, 1], activation="Tanh",
                 constraints=lambda f, x, y: f(bp[:, 0:1], bp[:, 1:2]) - gb))


def _ex30(pkg, m):
    def lotka_volterra(f, t):
        u, v = f[:, 0:1], f[:, 1:2]
        return (pkg.D(u, t) - u + u * v, pkg.D(v, t) + 1.5 * v - u * v)
    return lotka_volterra, dict(
        ndims=1, activation="Tanh", layout="fa fa B f .", features=[8, 8, 1],
        branches=[dict(layout="fa f", features=[8, 1])], domain=(0.0, 2.0),
        initial_condition=np.array([2.0, 1.0]))


ZERO = np.array([0.0], np.float32)


def _ex31(pkg, m):
    k = 12.0
    return (lambda f, x: pkg.D(pkg.D(f, x), x) + k * k * f,
            dict(ndims=1, layout="fa fa fa f", features=[8, 8, 8, 1],
                 activation="Tanh",
                 constraints=(lambda f, x: f(ZERO),
                              lambda f, x: f.grad(ZERO, wrt=0) - k)))


def _ex32(pkg, m):
    def poisson(f, x, y):
        return (pkg.D(pkg.D(f, x), x) + pkg.D(pkg.D(f, y), y)
                + 5.0 * m.sin(np.pi * (x + y)))
    return poisson, dict(ndims=2, boundary_condition=1, layout="fa fa fa f",
                         features=[8, 8, 8, 1], activation="Tanh",
                         adaptive_activation=10.0)


def _terms(weights):
    return (("equation", 1.0),) + tuple(
        (f"constraint_{k}", w) for k, w in enumerate(weights))


# name: (make, loss terms)
PARITY = {
    "07_system_of_equations": (_ex07, _terms(())),
    "09_adaptive_collocation": (_ex09, _terms(())),
    "12_biharmonic_beam": (_ex12, _terms((10.0, 10.0))),
    "14_navier_stokes_taylor_green": (_ex14, _terms((10.0,))),
    "15_schrodinger_soliton": (_ex15, _terms(())),
    "16_burgers_shock": (_ex16, _terms(())),
    "17_poisson_3d": (_ex17, _terms(())),
    "21_multiscale_poisson": (_ex21, _terms(())),
    "22_unknown_field_inverse": (_ex22, _terms((1000.0,))),
    "23_deep_ritz_variational": (_ex23("variational"), _terms(())),
    "23_deep_ritz_residual": (_ex23("residual"), _terms(())),
    "24_lshape_corner_singularity": (_ex24, _terms((500.0,))),
    "30_branched_multihead": (_ex30, _terms(())),
    "31_ntk_balanced_helmholtz": (_ex31, _terms((1.0, 1.0))),
    "32_adaptive_activation": (_ex32, _terms(())),
}


@functools.lru_cache(maxsize=None)
def _jax_solver(name):
    eq, kw = PARITY[name][0](jpdt, jnp_sym)
    return jpdt.Solver(eq, seed=0, **kw)


def _pair(name):
    js = _jax_solver(name)
    eq, kw = PARITY[name][0](tpdt, torch)
    return js, copy_params(js, tpdt.Solver(eq, seed=0, device="cpu", **kw))


@pytest.mark.parametrize("name", list(PARITY))
def test_example_equation_matches_pydens_tpu_at_a_fixed_theta(name):
    js, ts = _pair(name)
    assert_loss_matches(js, ts, PARITY[name][1], points(ts))
