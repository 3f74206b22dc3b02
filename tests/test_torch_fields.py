"""``Field`` (a trainable unknown function) in pydens_tpu_torch against
pydens_tpu: its checks and messages, its initial leaves bit for bit, the
loss and gradient of a Field problem in one and two coordinates (the
coefficient form on the Taylor plan, the divergence form on nested ``D``)
at the same theta and points, the plan of each form, a prefix freeze, an
ensemble's ``predict_all`` / ``predict_std`` and per-member losses, and a
checkpoint round trip."""

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

from ensemble_cases import _jax_members, _port_members

VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
TERMS = (("equation", 1.0), ("constraint_0", 10.0))


def _obs():
    rng = np.random.default_rng(0)
    obs_x = rng.uniform(0, 1, (32, 1)).astype(np.float32)
    return obs_x, np.sin(np.pi * obs_x).astype(np.float32)


def _inverse(pdt, field, n_models=1, seed=0):
    """tests/test_fields.py's problem: u'' = s(x), u(0) = u(1) = 0, the
    solution pinned by observations (examples/22 at a narrow width)."""
    obs_x, obs_u = _obs()
    target = obs_u if pdt is jpdt else torch.from_numpy(obs_u)
    kw = {} if pdt is jpdt else dict(device="cpu")
    return pdt.Solver(lambda f, x: pdt.D(pdt.D(f, x), x) - field(x),
                      ndims=1, seed=seed, boundary_condition=0,
                      layout="fa f", features=[16, 1], activation="Tanh",
                      constraints=lambda f, x: f(obs_x) - target,
                      n_models=n_models, **kw)


def _source(pdt, field, n_models=1, seed=0):
    """tests/test_fields.py's two-coordinate field: u_t = 0.1 u_xx + q."""
    kw = {} if pdt is jpdt else dict(device="cpu")
    return pdt.Solver(lambda f, x, t: pdt.D(f, t) - 0.1 * pdt.D(pdt.D(f, x), x)
                      - field(x, t), ndims=2, seed=seed,
                      initial_condition=0.0, layout="fa f", features=[16, 1],
                      activation="Tanh", n_models=n_models, **kw)


def _divergence(pdt, field, n_models=1, seed=0):
    """The divergence form: the field inside D voids the plan."""
    kw = {} if pdt is jpdt else dict(device="cpu")
    return pdt.Solver(lambda f, x: pdt.D(field(x) * pdt.D(f, x), x) - 1.0,
                      ndims=1, seed=seed, boundary_condition=0,
                      layout="fa f", features=[16, 1], activation="Tanh",
                      n_models=n_models, **kw)


PROBLEMS = {"one_coordinate": (_inverse, TERMS, [8, 1]),
            "two_coordinates": (_source, (("equation", 1.0),), [8, 1]),
            "deep_field": (_inverse, TERMS, [6, 5, 1]),
            "divergence": (_divergence, (("equation", 1.0),), [8, 1])}


@functools.lru_cache(maxsize=None)
def _jax_problem(name, n_models=1):
    """The JAX solver and field of a problem, shared by the tests (the
    ensemble test, the one user of K = 2, sets its parameters)."""
    make, _, features = PROBLEMS[name]
    jf = jpdt.Field("s", features=features)
    return make(jpdt, jf, n_models), jf


def _pair(name, n_models=1):
    make, _, features = PROBLEMS[name]
    js, jf = _jax_problem(name, n_models)
    tf = tpdt.Field("s", features=features)
    return js, make(tpdt, tf, n_models), jf, tf


def _copy_params(js, ts):
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))


def test_validation_messages_match_jax():
    # The JAX tests' invalid uses raise the same errors in both packages.
    for pdt in (jpdt, tpdt):
        with pytest.raises(ValueError, match="dot-free"):
            pdt.Field("a.b")
        with pytest.raises(ValueError, match="at least one dense layer"):
            pdt.Field("k", features=[])
        with pytest.raises(RuntimeError, match="Solver context"):
            pdt.Field("kappa")(np.zeros((4, 1)))
        sf = pdt.Field("s")
        _inverse(pdt, sf)
        assert sf.in_dim == 1
        kw = {} if pdt is jpdt else dict(device="cpu")
        with pytest.raises(ValueError, match="fixed signature"):
            pdt.Solver(lambda f, x, t: pdt.D(f, t) - sf(x, t), ndims=2,
                       seed=0, initial_condition=0.0, **kw)
        with pytest.raises(RuntimeError, match="never used"):
            pdt.Field("unused").predict(None, np.zeros(3))


@pytest.mark.parametrize("name", ["one_coordinate", "two_coordinates",
                                  "deep_field"])
def test_initial_leaves_equal_jax_bit_for_bit(name):
    # Drawn on the host from SeedSequence([seed, *map(ord, name)]) in both
    # packages: the registered leaves are equal bit for bit, names and
    # shapes too, and the field's value at fresh points agrees.
    js, ts, jf, tf = _pair(name)
    jv, tv = js.params["variables"], ts.params["variables"]
    assert set(tv) == set(jv) == set(tf.leaf_names())
    for k in tf.leaf_names():
        np.testing.assert_array_equal(tv[k].detach().numpy(),
                                      np.asarray(jv[k]))
    xs = np.linspace(0, 1, 9, dtype=np.float32)
    cols = (xs,) if tf.in_dim == 1 else (xs, 0.5)
    np.testing.assert_allclose(tf.predict(ts, *cols), jf.predict(js, *cols),
                               **VALUE_TOL)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_loss_and_grads_match_jax(name):
    # At theta copied from JAX (the field's leaves among its variables)
    # and 96 seeded points: loss rtol 2e-5, gradient rtol 2e-3 / atol
    # 2e-5; the coefficient forms on the Taylor plan, the divergence form
    # on nested D.
    js, ts, _, _ = _pair(name)
    terms = PROBLEMS[name][1]
    _copy_params(js, ts)
    pts = np.random.default_rng(7).uniform(
        size=(96, ts.model.total)).astype(np.float32)
    use_plan = bool(ts._plan_ok)
    jloss_fn, *_ = js._build_loss_fn(
        terms, lambda a, b: jnp.mean((a - b) ** 2), use_plan=use_plan)
    jl, jg = jax.value_and_grad(lambda p: jloss_fn(
        p, [jnp.asarray(pts[:, k:k + 1]) for k in range(pts.shape[1])]))(
            js.model.params)
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=use_plan)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    loss = loss_fn(theta, torch.from_numpy(pts))
    grad, = torch.autograd.grad(loss, theta)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        grad.numpy(), np.concatenate([np.ravel(np.asarray(g))
                                      for g in jax.tree.leaves(jg)]),
        **GRAD_TOL)


@pytest.mark.parametrize("name,planned", [("one_coordinate", True),
                                          ("two_coordinates", True),
                                          ("divergence", False)])
def test_plan_of_each_form_matches_jax(name, planned):
    # kappa(x) * D(D(f, x), x) stays planned with the same taps; D(kappa(x)
    # * D(f, x), x) voids the plan in both packages.
    js, ts, _, _ = _pair(name)
    assert bool(ts._plan_ok) == bool(js._plan_ok) == planned
    if planned:
        assert set(ts._plan_derivs) == set(js._plan_derivs)


def test_prefix_freeze():
    # freeze_trainable(variables=['s']) freezes every leaf of the field by
    # prefix; the network still trains; an unknown name raises.
    _, ts, _, _ = _pair("one_coordinate")
    ts.fit(niters=10, batch_size=64, progress=False)
    ts.model.freeze_trainable(variables=["s"])
    leaves0 = {k: v.detach().clone()
               for k, v in ts.params["variables"].items()}
    net0 = ts.params["net"]["fc1"]["w"].detach().clone()
    ts.fit(niters=10, batch_size=64, progress=False,
           loss_terms=["equation", "constraint_0"])
    for k, v in ts.params["variables"].items():
        assert torch.equal(v.detach(), leaves0[k]), k
    assert not torch.equal(ts.params["net"]["fc1"]["w"].detach(), net0)
    with pytest.raises(AttributeError, match="unknown"):
        ts.model.freeze_trainable(variables=["nope"])
    ts.model.unfreeze_trainable(variables=["s"])
    ts.fit(niters=5, batch_size=64, progress=False)
    assert not torch.equal(ts.params["variables"]["s.fc1.w"].detach(),
                           leaves0["s.fc1.w"])


@pytest.mark.parametrize("name", ["one_coordinate", "two_coordinates"])
def test_ensemble_matches_jax(name):
    # K = 2: the field's leaves stacked (2, ...) like V leaves and equal at
    # the start; with the JAX members copied in, predict_all, predict and
    # predict_std equal JAX's (rtol/atol 2e-5), and each member's loss and
    # gradient equal jax.vmap's of the JAX loss.
    js, ts, jf, tf = _pair(name, n_models=2)
    in_dim = 1 if name == "one_coordinate" else 2
    assert tuple(ts.params["variables"]["s.fc1.w"].shape) == (2, in_dim, 8)
    w = ts.params["variables"]["s.fc1.w"].detach()
    assert torch.equal(w[0], w[1])
    # Move the members' fields apart, then copy JAX's members in.
    params = jax.tree.map(lambda t: np.array(t), js.model.params)
    for v in params["variables"].values():
        v[1] *= 1.25
    js.model.params = jax.tree.map(jnp.asarray, params)
    _copy_params(js, ts)
    xs = np.linspace(0, 1, 11, dtype=np.float32)
    cols = (xs,) if tf.in_dim == 1 else (xs, 0.25)
    allp = tf.predict_all(ts, *cols)
    assert allp.shape == (2, 11, 1) and allp.dtype == np.float32
    np.testing.assert_allclose(allp, jf.predict_all(js, *cols), **VALUE_TOL)
    np.testing.assert_allclose(tf.predict(ts, *cols), jf.predict(js, *cols),
                               **VALUE_TOL)
    np.testing.assert_allclose(tf.predict_std(ts, *cols),
                               jf.predict_std(js, *cols), **VALUE_TOL)
    pts = np.random.default_rng(7).uniform(
        size=(64, ts.model.total)).astype(np.float32)
    terms = PROBLEMS[name][1]
    jl, jg = _jax_members(js, terms, pts)
    tl, tg, _, _ = _port_members(ts, terms, pts)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, **GRAD_TOL)
    single = tpdt.Field("t", features=[8, 1])
    _inverse(tpdt, single)
    with pytest.raises(ValueError, match="n_models"):
        single.predict_std(_inverse(tpdt, single), xs)


def test_checkpoint_round_trip(tmp_path):
    # A fitted Field problem saved and loaded into a fresh solver of the
    # same problem (another seed): the field's leaves and its predictions
    # equal bit for bit.
    _, ts, _, tf = _pair("one_coordinate")
    ts.fit(niters=20, batch_size=64, progress=False,
           loss_terms=["equation", "constraint_0"])
    path = str(tmp_path / "field.npz")
    ts.save(path)
    tf2 = tpdt.Field("s", features=[8, 1])
    ts2 = _inverse(tpdt, tf2, seed=3)
    ts2.load(path)
    for k, v in ts.params["variables"].items():
        assert torch.equal(ts2.params["variables"][k].detach(), v.detach())
    xs = np.linspace(0, 1, 20)
    np.testing.assert_array_equal(tf2.predict(ts2, xs), tf.predict(ts, xs))
    np.testing.assert_array_equal(ts2.predict(xs), ts.predict(xs))
