"""The model options of pydens_tpu_torch against pydens_tpu at fixed inputs:
periodic embeddings (tuple and dict harmonics), random Fourier features,
the second initial condition (with and without the decaying periodic
binding), the gated modified MLP, adaptive activations on a chain and in a
branch, and the ``B`` token with its ``+``, ``*`` and ``.`` joins and
LayerNorm ``n``.  For each: the network value, the Taylor taps from the
embedding's state, the ansatz and its taps, and the loss and its gradient,
with θ copied from the JAX solver through ``params_from_jax`` and the
points from seeded numpy; the routing of each model to the kernels; and
``predict``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.utils.criteria import mse_loss

LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
# Values rtol/atol 2e-5; Taylor taps rtol 1e-4 / atol 1e-5 as
# tests/test_torch_layout.py (higher taps accumulate more rounding; the
# embeddings' taps carry factors up to (2 pi k)^2).
VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
TAP_TOL = dict(rtol=1e-4, atol=1e-5)


def _heat(pdt):
    def heat(f, x, t):
        return pdt.D(f, t) - 0.1 * pdt.D(pdt.D(f, x), x)
    return heat


def _wave(pdt):
    def wave(f, x, t):
        return pdt.D(pdt.D(f, t), t) - pdt.D(pdt.D(f, x), x)
    return wave


def _poisson(pdt):
    def poisson(f, x, y):
        return (pdt.D(pdt.D(f, x), x) + pdt.D(pdt.D(f, y), y)
                - 5 * pdt.sin(np.pi * (x + y)))
    return poisson


def _system(pdt):
    # examples/30's Lotka-Volterra pair: two outputs, first order.
    def lv(f, t):
        u, v = f[:, 0:1], f[:, 1:2]
        return (pdt.D(u, t) - u + u * v, pdt.D(v, t) + 1.5 * v - u * v)
    return lv


def _sin_ic(pdt):
    return lambda x: pdt.sin(2 * np.pi * x)


def _kink_ic(pdt):
    return lambda x: x ** 2 * pdt.cos(np.pi * x)


# name: (equation, options), each a function of the package (pydens_tpu or
# pydens_tpu_torch) whose math the callables use.
WORKLOADS = {
    "periodic_tuple": (_heat, lambda pdt: dict(
        ndims=2, periodic=(0,), initial_condition=_sin_ic(pdt),
        layout="fa fa f", features=[12, 12, 1], activation="Tanh")),
    "periodic_dict": (_heat, lambda pdt: dict(
        ndims=2, periodic={0: 3}, domain=[(-1, 1), (0, 1)],
        initial_condition=_kink_ic(pdt), periodic_ic_decay=False,
        layout="fa fa f", features=[12, 12, 1], activation="Tanh")),
    "periodic_dirichlet": (_poisson, lambda pdt: dict(
        ndims=2, periodic={0: 2}, boundary_condition=0.5,
        layout="fa fa f", features=[12, 10, 1], activation="Tanh")),
    "fourier_tuple": (_heat, lambda pdt: dict(
        ndims=2, fourier_features=(4, 2.0), initial_condition=_sin_ic(pdt),
        layout="fa fa f", features=[12, 12, 1], activation="Tanh")),
    "fourier_dict": (_poisson, lambda pdt: dict(
        ndims=2, fourier_features=dict(m=3, sigma=1.5, dims=(1,)),
        periodic=(0,), boundary_condition=0.0, layout="fa fa f",
        features=[10, 10, 1], activation="Sigmoid")),
    "second_ic": (_wave, lambda pdt: dict(
        ndims=2, initial_condition=_sin_ic(pdt),
        initial_condition_t=lambda x: 0.5 * pdt.cos(np.pi * x),
        boundary_condition=0.0, layout="fa fa f", features=[12, 12, 1],
        activation="Tanh")),
    "second_ic_decay": (_wave, lambda pdt: dict(
        ndims=2, periodic={0: 2}, initial_condition=_sin_ic(pdt),
        initial_condition_t=0.25, periodic_ic_decay=True,
        layout="fa fa f", features=[12, 12, 1], activation="Tanh")),
    "modified": (_heat, lambda pdt: dict(
        ndims=2, initial_condition=_sin_ic(pdt), boundary_condition=0.0,
        arch="modified", features=[8, 8, 8, 1], activation="Tanh")),
    "modified_periodic": (_heat, lambda pdt: dict(
        ndims=2, initial_condition=_sin_ic(pdt), periodic=True,
        arch="modified_mlp", features=[8, 8, 1], activation="Sigmoid")),
    "laaf_chain": (_poisson, lambda pdt: dict(
        ndims=2, boundary_condition=1.0, layout="fa fa fa f",
        features=[10, 12, 15, 1], activation="Tanh",
        adaptive_activation=10.0)),
    "laaf_branch": (_system, lambda pdt: dict(
        ndims=1, initial_condition=np.array([2.0, 1.0]), domain=(0.0, 2.0),
        layout="fa fa B f .", features=[12, 12, 1],
        branches=[dict(layout="fa f", features=[6, 1])],
        adaptive_activation=5.0, activation="Tanh")),
    "branch_concat": (_system, lambda pdt: dict(
        ndims=1, initial_condition=np.array([2.0, 1.0]), domain=(0.0, 2.0),
        layout="fa fa B f .", features=[12, 12, 1],
        branches=[dict(layout="fa f", features=[6, 1])],
        activation="Tanh")),
    "branch_sum": (_heat, lambda pdt: dict(
        ndims=2, initial_condition=_sin_ic(pdt), layout="fa B fa + f",
        features=[10, 10, 1], activation="Tanh")),
    "branch_product": (_heat, lambda pdt: dict(
        ndims=2, initial_condition=_sin_ic(pdt), layout="fa B fa * f",
        features=[10, 10, 1], branches=[dict(layout="fa", features=[10])],
        activation="Sigmoid")),
    "layernorm": (_heat, lambda pdt: dict(
        ndims=2, initial_condition=_sin_ic(pdt), layout="fan fa f",
        features=[10, 10, 1], activation="Tanh")),
}
CLOSURE = {1: [(0,), (0, 0)], 2: [(0,), (1,), (0, 0), (0, 1), (1, 1)]}


@functools.lru_cache(maxsize=None)
def _jax_solver(name):
    eq, opts = WORKLOADS[name]
    return jpdt.Solver(eq(jpdt), seed=0, **opts(jpdt))


def _pair(name):
    """The JAX and the port's solver of one workload, the JAX parameters
    copied into the port."""
    js = _jax_solver(name)
    eq, opts = WORKLOADS[name]
    ts = tpdt.Solver(eq(tpdt), seed=0, device="cpu", **opts(tpdt))
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    return js, ts


def _points(name, n=80, seed=7):
    js = _jax_solver(name)
    lo = np.array([d[0] for d in js.model.domain], np.float32)
    hi = np.array([d[1] for d in js.model.domain], np.float32)
    u = np.random.default_rng(seed).uniform(size=(n, len(lo)))
    return (lo + (hi - lo) * u).astype(np.float32)


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(g))
                           for g in jax.tree.leaves(tree)])


def _jax_mse(a, b):
    return jnp.mean((a - b) ** 2)


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_network_value_and_ansatz_match_jax(name):
    js, ts = _pair(name)
    pts = _points(name)
    jm, tm = js.model, ts.model
    assert tm.layer_names == list(jm.layer_names)
    assert set(tm.params["net"]) == set(jm.params["net"])
    net = tm.network_apply(tm.params["net"], torch.from_numpy(pts))
    np.testing.assert_allclose(
        net.detach().numpy(),
        np.asarray(jm.network_apply(jm.params["net"], jnp.asarray(pts))),
        **VALUE_TOL)
    full = tm.apply(tm.params, torch.from_numpy(pts))
    np.testing.assert_allclose(
        full.detach().numpy(),
        np.asarray(jm.apply(jm.params, jnp.asarray(pts))), **VALUE_TOL)


@pytest.mark.parametrize("name", [n for n in WORKLOADS if n != "layernorm"])
def test_taylor_taps_match_jax(name):
    # The network's taps (from the embedding's closed-form state where the
    # model embeds; JAX takes nested jvp of the embedding) and the ansatz's
    # taps through full_taps.
    js, ts = _pair(name)
    pts = _points(name, n=40)
    closure = CLOSURE[ts.model.total]
    jV, jtaps = js.model.network_apply_taylor(js.model.params["net"],
                                              jnp.asarray(pts), closure)
    tV, ttaps = ts.model.network_apply_taylor(ts.model.params["net"],
                                              torch.from_numpy(pts), closure)
    np.testing.assert_allclose(tV.detach().numpy(), np.asarray(jV),
                               **VALUE_TOL)
    for mi in closure:
        np.testing.assert_allclose(ttaps[mi].detach().numpy(),
                                   np.asarray(jtaps[mi]), **TAP_TOL,
                                   err_msg=str(mi))
    derivs = [mi for mi in closure if len(mi) == 2 or ts.model.total == 1]
    jfull = js.model.full_taps(js.model.params, jnp.asarray(pts), derivs)
    tfull = ts.model.full_taps(ts.model.params, torch.from_numpy(pts),
                               derivs)
    assert set(tfull) == set(jfull)
    for mi, ref in jfull.items():
        np.testing.assert_allclose(tfull[mi].detach().numpy(),
                                   np.asarray(ref), **TAP_TOL,
                                   err_msg=str(mi))


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_loss_and_grads_match_jax(name):
    # Loss rtol 2e-5, gradients rtol 2e-3 / atol 2e-5
    # (tests/test_torch_collocation.py), on the plan wherever pydens_tpu
    # plans (LayerNorm: nested gradients in both).
    js, ts = _pair(name)
    assert ts._plan_ok == js._plan_ok == (name != "layernorm")
    pts = _points(name, n=96)
    terms = (("equation", 1.0),)
    jloss_fn, *_ = js._build_loss_fn(terms, _jax_mse, use_plan=js._plan_ok)
    leaves = [jnp.asarray(pts[:, i:i + 1]) for i in range(pts.shape[1])]
    jl, jg = jax.value_and_grad(lambda p: jloss_fn(p, leaves))(
        js.model.params)
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=ts._plan_ok)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    loss = loss_fn(theta, torch.from_numpy(pts))
    grad, = torch.autograd.grad(loss, theta)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad.numpy(), _flat(jg), **GRAD_TOL)


# The kernels each model reaches: the Taylor kernels on plain chains, on
# the raw coordinates or from the embedding's Taylor state (where the JAX
# package keeps embedded models off its kernels,
# pydens_tpu/models/base.py:1027-1030), the MLP kernel after the embedding
# for f c a R + chains without slopes (:1051-1063), at the embedded width.
ROUTES = {
    "periodic_tuple": (True, 3), "periodic_dict": (True, 7),
    "periodic_dirichlet": (True, 5), "fourier_tuple": (True, 10),
    "fourier_dict": (True, 9), "second_ic": (True, 2),
    "second_ic_decay": (True, 5), "modified": (False, None),
    "modified_periodic": (False, None), "laaf_chain": (False, None),
    "laaf_branch": (False, None), "branch_concat": (False, None),
    "branch_sum": (False, None), "branch_product": (False, None),
    "layernorm": (False, None),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_routing_to_the_kernels(name):
    taylor, mlp_in = ROUTES[name]
    _, ts = _pair(name)
    model = ts.model
    if ts._plan_ok:
        closure = model.plan_closure(ts._plan_derivs)
        assert (model._fused_taylor_plan(closure) is not None) == taylor
    if mlp_in is None:
        assert model._mlp_plan is None
    else:
        assert model._mlp_plan is not None
        assert model._mlp_plan.in_dim == mlp_in


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_predict_matches_jax(name):
    # Solver.predict: the MLP kernel's plain version after the embedding on
    # the CPU where the model is in its scope, the network otherwise.
    js, ts = _pair(name)
    pts = _points(name, n=50, seed=3)
    np.testing.assert_allclose(ts.predict(pts), js.predict(pts),
                               **VALUE_TOL)


def test_fourier_matrix_is_pydens_tpus_bit_for_bit():
    for ff in (8, (8, 10.0), dict(m=8, sigma=10.0, dims=(0,)),
               (32, 8.0), dict(m=5, sigma=3.0)):
        jm = jpdt.ConvBlockModel(ndims=2, initial_condition=0.0,
                                 fourier_features=ff)
        tm = tpdt.ConvBlockModel(ndims=2, initial_condition=0.0,
                                 fourier_features=ff, device="cpu")
        np.testing.assert_array_equal(tm._rff_b, jm._rff_b)
        assert tm._rff_dims == jm._rff_dims
        assert torch.equal(tm._rff_bt, torch.from_numpy(jm._rff_b.T.copy()))
        x = np.random.default_rng(0).uniform(size=(9, 2)).astype(np.float32)
        np.testing.assert_allclose(tm._embed(torch.from_numpy(x)).numpy(),
                                   np.asarray(jm._embed(jnp.asarray(x))),
                                   **VALUE_TOL)


@pytest.mark.parametrize("ict", [0.0, np.array([2.0, 0.0])])
def test_second_initial_condition_is_bound_exactly(ict):
    # u(x, t0) = ic and u_t(x, t0) = ic_t, read through full_taps at t = 0
    # (tests/test_wave_second_ic.py's checks; predict_grad is not ported).
    def system(f, x, t):
        u = f[:, 0:1]
        return tpdt.D(tpdt.D(u, t), t) - tpdt.D(tpdt.D(u, x), x)
    n_out = np.size(ict)
    ic = np.array([0.0, 1.0]) if n_out == 2 else (lambda x: tpdt.sin(
        np.pi * x))
    s = tpdt.Solver(system, ndims=2, seed=0, layout="fa f",
                    features=[8, n_out], initial_condition=ic,
                    initial_condition_t=ict, device="cpu")
    xs = torch.linspace(0, 1, 11).reshape(-1, 1)
    pts = torch.cat([xs, torch.zeros_like(xs)], dim=1)
    taps = s.model.full_taps(s.model.params, pts, [(1,)])
    want_u = (np.tile([0.0, 1.0], (11, 1)) if n_out == 2
              else np.sin(np.pi * xs.numpy()))
    np.testing.assert_allclose(taps[()].detach().numpy(), want_u, atol=1e-6)
    want_t = np.broadcast_to(np.reshape(ict, (1, -1)), (11, n_out))
    np.testing.assert_allclose(taps[(1,)].detach().numpy(), want_t,
                               atol=1e-5)
