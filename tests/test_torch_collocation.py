"""The collocation and objective options of ``fit`` and ``Solver.residual``
against pydens_tpu at fixed inputs: the loss and its gradient with point
weights, term weights, causal weighting (eps 0 and 5, scalar and system),
the variational (Deep Ritz) formulation and constraints; the per-point
residual, the term blocks and ``Solver.residual``; adaptive sampling's and
RBA's weight formulas; the inverse-CDF selection; and every invalid
combination of the JAX tests, which raises the same ValueError in both
packages.  Parameters are copied from the JAX solver and the points come
from seeded numpy."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.solver import _adaptive_pick, _Collocation, _FitStep
from pydens_tpu_torch.solver import _rba_update
from pydens_tpu_torch.utils.criteria import mse_loss
from pydens_tpu_torch.utils.optimizers import resolve_optimizer

LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
ZERO = np.array([0.0], np.float32)
QUARTER = np.array([0.25], np.float32)


def _ode(pdt):
    # An ODE with an initial condition and two constraints, the second a
    # derivative at a fixed point.
    def ode(f, x):
        return pdt.D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x)
    return ode, dict(ndims=1, initial_condition=.5, activation="Tanh",
                     layout="fafaf", features=[12, 10, 1],
                     constraints=(lambda f, x: f(np.array([0.5])) - 0.5,
                                  lambda f, x: f.grad(QUARTER, wrt=0)))


def _heat(pdt):
    def heat(f, x, t):
        return pdt.D(f, t) - 0.1 * pdt.D(pdt.D(f, x), x)
    return heat, dict(ndims=2, initial_condition=lambda x: pdt.sin(np.pi * x),
                      activation="Tanh", layout="fa fa f",
                      features=[12, 12, 1])


def _wave_system(pdt):
    # tests/test_causal.py's coupled system: two residuals, two outputs.
    def system(f, x, t):
        u, v = f[:, 0:1], f[:, 1:2]
        return (pdt.D(u, t) + pdt.D(v, x), pdt.D(v, t) + pdt.D(u, x))
    return system, dict(ndims=2, initial_condition=np.array([0.0, 1.0]),
                        activation="Tanh", layout="fa f", features=[16, 2])


def _ritz(pdt):
    # tests/test_variational.py's 1D Deep Ritz energy of -u'' = pi^2 sin.
    def energy(f, x):
        return 0.5 * pdt.D(f, x) ** 2 - np.pi ** 2 * pdt.sin(np.pi * x) * f
    return energy, dict(ndims=1, boundary_condition=0, activation="Tanh",
                        layout="fa fa f", features=[16, 16, 1],
                        formulation="variational")


def _ritz_system(pdt):
    def energy(f, x):
        u, v = f[:, 0:1], f[:, 1:2]
        return (0.5 * pdt.D(u, x) ** 2 - u, 0.5 * pdt.D(v, x) ** 2 - 2 * v)
    return energy, dict(ndims=1, boundary_condition=0, activation="Tanh",
                        layout="fa f", features=[8, 2],
                        formulation="variational")


WORKLOADS = {"ode": _ode, "heat": _heat, "wave_system": _wave_system,
             "ritz": _ritz, "ritz_system": _ritz_system}
CAUSAL = (1, 0.0, 1.0)    # the time column and its domain
ODE_TERMS = (("equation", 1.0), ("constraint_0", 2.0), ("constraint_1", 0.5))


@functools.lru_cache(maxsize=None)
def _jax_solver(name):
    eq, kw = WORKLOADS[name](jpdt)
    return jpdt.Solver(eq, seed=0, **kw)


def _pair(name):
    """The JAX and the port's Solver of one workload, the JAX parameters
    copied into the port."""
    js = _jax_solver(name)
    eq, kw = WORKLOADS[name](tpdt)
    ts = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    return js, ts


def _points(n, total, seed=7):
    return np.random.default_rng(seed).uniform(
        size=(n, total)).astype(np.float32)


def _jax_mse(a, b):
    return jnp.mean((a - b) ** 2)


def _leaves(pts):
    return [jnp.asarray(pts[:, i:i + 1]) for i in range(pts.shape[1])]


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(g))
                           for g in jax.tree.leaves(tree)])


# (workload, loss terms, causal, point weights, term weights, causal eps)
LOSS_CASES = {
    "point_weight": ("ode", (("equation", 1.0),), None, True, None, None),
    "term_weights": ("ode", ODE_TERMS, None, False, (0.7, 3.0, 11.0), None),
    "constraints": ("ode", ODE_TERMS, None, False, None, None),
    "causal_eps0": ("heat", (("equation", 1.0),), CAUSAL, False, None, 0.0),
    "causal_eps5": ("heat", (("equation", 1.0),), CAUSAL, False, None, 5.0),
    "causal_eps0_system": ("wave_system", (("equation", 1.0),), CAUSAL,
                           False, None, 0.0),
    "causal_eps5_system": ("wave_system", (("equation", 1.0),), CAUSAL,
                           False, None, 5.0),
    "variational": ("ritz", (("equation", 1.0),), None, False, None, None),
    "variational_system": ("ritz_system", (("equation", 1.0),), None, False,
                           None, None),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_grads_match_jax(case):
    # Fixed 96 points, copied theta and seeded per-point weights: loss rtol
    # 2e-5, gradients rtol 2e-3 / atol 2e-5 (tests/test_torch_solver.py's
    # tolerances).  The weights carry no gradient in either package.
    name, terms, causal, weighted, term_w, eps = LOSS_CASES[case]
    js, ts = _pair(name)
    pts = _points(96, ts.model.total)
    pw = (np.random.default_rng(1).uniform(0.5, 2.0, 96).astype(np.float32)
          if weighted else None)
    jloss_fn, *_ = js._build_loss_fn(terms, _jax_mse, use_plan=True,
                                     causal=causal)
    jargs = (None if pw is None else jnp.asarray(pw),
             None if term_w is None else jnp.asarray(term_w, jnp.float32),
             None if eps is None else jnp.float32(eps))
    jl, jg = jax.value_and_grad(
        lambda p: jloss_fn(p, _leaves(pts), *jargs))(js.model.params)

    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=True,
                                causal=causal)
    assert loss_fn.term_order == tuple(terms)
    theta = loss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    targs = (None if pw is None else torch.from_numpy(pw),
             None if term_w is None else torch.tensor(term_w),
             None if eps is None else torch.tensor(eps))
    loss = loss_fn(theta, torch.from_numpy(pts), *targs)
    grad, = torch.autograd.grad(loss, theta)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad.numpy(), _flat(jg), **GRAD_TOL)


@pytest.mark.parametrize("name", ["heat", "wave_system"])
def test_causal_eps_zero_is_the_plain_mse(name):
    # The self-normalized bin weighting at eps = 0 is the plain MSE: the
    # same loss as the builder without causal (rtol 1e-6).
    _, ts = _pair(name)
    pts = torch.from_numpy(_points(96, ts.model.total))
    terms = (("equation", 1.0),)
    theta = _theta(ts)
    plain = ts._build_loss_fn(terms, mse_loss, use_plan=True)(theta, pts)
    causal = ts._build_loss_fn(terms, mse_loss, use_plan=True,
                               causal=CAUSAL)(theta, pts,
                                              causal_eps=torch.tensor(0.0))
    np.testing.assert_allclose(float(causal.detach()), float(plain.detach()),
                               rtol=1e-6)


def _theta(ts):
    return ts._build_loss_fn((("equation", 1.0),), mse_loss).spec.flatten(
        ts.model.params).detach()


@pytest.mark.parametrize("name,terms", [
    ("ode", ODE_TERMS), ("wave_system", (("equation", 1.0),)),
    ("ritz", (("equation", 1.0),))])
def test_point_residual_and_term_blocks_match_jax(name, terms):
    # The per-point |residual| (|density| under variational) and the
    # per-term blocks scaled by 1/sqrt(size) (a system's residuals one
    # block), values rtol/atol 2e-5; each block's squared sum is its
    # unweighted MSE term.
    js, ts = _pair(name)
    pts = _points(64, ts.model.total)
    _, jres, jresvec = js._build_loss_fn(terms, _jax_mse, use_plan=True)
    loss_fn = ts._build_loss_fn(terms, mse_loss, use_plan=True)
    theta = loss_fn.spec.flatten(ts.model.params).detach()
    x = torch.from_numpy(pts)
    r = loss_fn.point_residual(theta, x)
    assert r.shape == (64, 1)
    np.testing.assert_allclose(
        r.detach().numpy(), np.asarray(jres(js.model.params, _leaves(pts))),
        rtol=2e-5, atol=2e-5)
    blocks = loss_fn.term_blocks(theta, x)
    jblocks = jresvec.term_blocks(js.model.params, _leaves(pts))
    assert len(blocks) == len(jblocks) == len(terms)
    for b, jb in zip(blocks, jblocks):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb),
                                   rtol=2e-5, atol=2e-5)
    if ts.formulation == "residual":
        parts = loss_fn.terms(*loss_fn.evaluate(theta, x), x)
        for b, t in zip(blocks, parts):
            np.testing.assert_allclose(float(torch.sum(b * b).detach()),
                                       float(t.detach()), rtol=1e-5)


@pytest.mark.parametrize("name", ["ode", "wave_system"])
def test_solver_residual_matches_jax(name):
    js, ts = _pair(name)
    xs = _points(50, ts.model.total, seed=3)
    cols = [xs[:, i] for i in range(xs.shape[1])]
    out = ts.residual(*cols)
    assert isinstance(out, np.ndarray) and out.shape == (50, 1)
    np.testing.assert_allclose(out, np.asarray(js.residual(*cols)),
                               rtol=2e-5, atol=2e-5)


def test_adaptive_and_rba_weights_match_jax_formulas():
    # Given the picked indices, the importance weights 1/(M p) of
    # pydens_tpu/solver.py:1254-1255; the picks are the inverse CDF's
    # (cdf[i-1] <= u < cdf[i]); RBA's update of :1286-1293.
    rng = np.random.default_rng(0)
    m_pool = 300
    r = rng.exponential(size=m_pool).astype(np.float32)
    u = rng.uniform(size=64).astype(np.float32)
    idx, w = _adaptive_pick(torch.from_numpy(r), torch.from_numpy(u), m_pool)
    probs = jnp.asarray(r) / (jnp.sum(jnp.asarray(r)) + 1e-30)
    jidx = jnp.asarray(idx.numpy())
    np.testing.assert_allclose(
        w.numpy(), np.asarray(1.0 / (m_pool * probs[jidx] + 1e-30)),
        rtol=1e-6)
    cdf = np.cumsum(np.asarray(probs, np.float64))
    i = idx.numpy()
    assert np.all(u < cdf[i] + 1e-6)
    assert np.all(np.where(i > 0, cdf[np.maximum(i - 1, 0)], 0.0)
                  <= u + 1e-6)

    rba_w = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    res = rng.exponential(size=128).astype(np.float32)
    for eta, gamma in ((0.01, 0.999), (0.05, 0.9)):
        ref = (gamma * jnp.asarray(rba_w) + eta * jnp.asarray(res)
               / (jnp.max(jnp.asarray(res)) + 1e-30))
        out = _rba_update(torch.from_numpy(rba_w), torch.from_numpy(res),
                          eta, gamma)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_inverse_cdf_selection_draws_the_categorical():
    # 200,000 picks at a fixed seed: the frequencies of a 12-way
    # distribution with a zero entry pass a chi-square test (p > 1e-3) and
    # the zero entry is never picked (JAX's Gumbel categorical draws from
    # the same distribution).
    probs = np.array([5, 1, 0, 3, 8, 2, 2, 7, 1, 4, 6, 1], np.float64)
    probs /= probs.sum()
    u = torch.from_numpy(np.random.default_rng(11).uniform(
        size=200_000).astype(np.float32))
    idx, _ = _adaptive_pick(torch.from_numpy(probs.astype(np.float32)), u,
                            len(probs))
    counts = np.bincount(idx.numpy(), minlength=len(probs))
    assert counts[2] == 0
    keep = probs > 0
    p = scipy.stats.chisquare(counts[keep],
                              probs[keep] * counts.sum()).pvalue
    assert p > 1e-3, (counts, p)


def test_adaptive_batch_is_the_hybrid_of_jax():
    # One step's batch from 4 x 16 candidates: the last 8 join uniformly
    # (weight 1), the other 8 are picked from the first 56 by the inverse
    # CDF of their |residual| (JAX's point_residual on the same pool and
    # theta) with weights 1/(M p).
    js, ts = _pair("heat")
    loss_fn = ts._build_loss_fn((("equation", 1.0),), mse_loss,
                                use_plan=True)
    theta = loss_fn.spec.flatten(ts.model.params)
    step = _FitStep(loss_fn, resolve_optimizer("Adam", 0.0, {}), None,
                    theta, 1, 16, True, False, False,
                    options=_Collocation(adaptive=4))
    cand = _points(64, 2, seed=5)
    step.points[0].copy_(torch.from_numpy(cand))
    u = np.random.default_rng(2).uniform(size=8).astype(np.float32)
    step.uniforms[0].copy_(torch.from_numpy(u))
    pts, weight = step._batch()
    _, jres, _ = js._build_loss_fn((("equation", 1.0),), _jax_mse,
                                   use_plan=True)
    r = np.asarray(jres(js.model.params, _leaves(cand[:56])))[:, 0]
    probs = r / (r.sum() + 1e-30)
    idx = np.minimum(np.searchsorted(np.cumsum(probs), u, side="right"), 55)
    np.testing.assert_array_equal(pts.numpy(),
                                  np.concatenate([cand[56:], cand[idx]]))
    np.testing.assert_allclose(
        weight.numpy(),
        np.concatenate([np.ones(8), 1.0 / (56 * probs[idx] + 1e-30)]),
        rtol=1e-4)


# The invalid calls of the JAX tests (tests/test_adaptive.py:53,
# test_rba.py:71, test_causal.py:94, test_loss_balancing.py:79,
# test_ntk_balancing.py:172, test_variational.py:55), each with its
# solver and the message both packages match.
def _beam(pdt):
    return dict(equation=lambda f, x: pdt.D(pdt.D(pdt.D(pdt.D(
        f, x), x), x), x) - 384.0, ndims=1, boundary_condition=0,
        layout="fa fa f", features=[8, 8, 1], activation="Tanh",
        constraints=(lambda f, x: f.grad(ZERO, wrt=0),
                     lambda f, x: f.grad(np.array([1.0], np.float32),
                                         wrt=0)))


SOLVERS = {
    "ode_c": lambda pdt: dict(equation=lambda f, x: pdt.D(f, x), ndims=1,
                              constraints=lambda f, x: f(0.5)),
    "stiff": lambda pdt: dict(
        equation=lambda f, x: pdt.D(f, x)
        - 50 * pdt.exp(-500 * (x - 0.8) ** 2), ndims=1,
        initial_condition=0.0, layout="fa f", features=[8, 1],
        constraints=lambda f, x: f(np.zeros(1))),
    "heat_c": lambda pdt: dict(
        equation=lambda f, x, t: pdt.D(f, t) - 0.1 * pdt.D(pdt.D(f, x), x),
        ndims=2, initial_condition=lambda x: 0 * x, layout="fa f",
        features=[8, 1],
        constraints=(lambda f, x, t: f.grad(ZERO, ZERO, wrt=0),)),
    "no_time": lambda pdt: dict(equation=lambda f, x: pdt.D(f, x) - 1.0,
                                ndims=1),
    "beam": _beam,
    "ritz": lambda pdt: dict(
        equation=lambda f, x: pdt.D(f, x) ** 2 / 2 - f, ndims=1,
        boundary_condition=0.0, formulation="variational"),
    "ritz_t": lambda pdt: dict(
        equation=lambda f, x, t: 0.5 * pdt.D(f, x) ** 2 - f, ndims=2,
        initial_condition=0.0, formulation="variational", layout="fa f",
        features=[8, 1]),
}

LT1 = {"equation": 1.0, "constraint_0": 1.0, "constraint_1": 1.0}
EC = {"equation": 1.0, "constraint_0": 1.0}
INVALID = [
    ("ode_c", dict(adaptive=1), ">= 2"),
    ("ode_c", dict(adaptive=4, loss_terms=["constraint_0"]),
     "equation residual"),
    ("ode_c", dict(adaptive=4, sampler="scipy"), "device-side"),
    ("ode_c", dict(adaptive=4, criterion="l1"), "MSE"),
    ("stiff", dict(rba=True), "resample=False"),
    ("stiff", dict(resample=False, rba=True, adaptive=4), "use one"),
    ("stiff", dict(resample=False, rba=True, criterion="l1"), "MSE"),
    ("stiff", dict(resample=False, rba="yes"), "not understood"),
    ("stiff", dict(resample=False, rba=(0.0, 0.5)), "eta > 0"),
    ("stiff", dict(resample=False, rba=True, optimizer="LBFGS"),
     "linesearch|LBFGS|Adam"),
    ("stiff", dict(resample=False, rba=True, loss_terms=["constraint_0"]),
     "equation"),
    ("heat_c", dict(resample=False, rba=True, causal=1.0), "one of the two"),
    ("ritz", dict(resample=False, rba=True), "variational"),
    ("no_time", dict(causal=1.0), "time axis"),
    ("heat_c", dict(causal=1.0, criterion="l1"), "MSE"),
    ("heat_c", dict(causal=1.0, adaptive=4), "one"),
    ("heat_c", dict(causal=-1.0), ">= 0"),
    ("heat_c", dict(causal=1.0, loss_terms=["constraint_0"]), "equation"),
    ("heat_c", dict(causal=1.0, causal_axis=7), "out of range"),
    ("heat_c", dict(causal_axis=0), "causal_axis"),
    ("no_time", dict(loss_balancing=True), "at least two loss terms"),
    ("beam", dict(loss_terms=LT1, optimizer="LBFGS", resample=False,
                  loss_balancing=True), "linesearch"),
    ("beam", dict(loss_terms=LT1, loss_balancing=-5), "positive"),
    ("beam", dict(loss_terms=LT1, loss_balancing="spectral"),
     "not recognized"),
    ("beam", dict(loss_terms=LT1, loss_balancing=("ntk", 100, 7)),
     "exactly two"),
    ("beam", dict(loss_terms=LT1, loss_balancing="ntk",
                  criterion="L1Loss"), "MSE"),
    ("beam", dict(loss_terms=LT1, loss_balancing="ntk",
                  criterion="callable_l1"), "MSE"),
    ("beam", dict(loss_terms=LT1, rba=True, loss_balancing="ntk"), "rba"),
    ("heat_c", dict(causal=1.0, loss_terms=EC, loss_balancing="ntk"),
     "causal"),
    ("ritz_t", dict(adaptive=4), "variational"),
    ("ritz_t", dict(causal=1.0), "variational"),
    ("ritz_t", dict(loss_balancing="ntk", loss_terms=EC), "variational"),
]


@functools.lru_cache(maxsize=None)
def _invalid_solver(pkg, key):
    pdt = jpdt if pkg == "jax" else tpdt
    kw = SOLVERS[key](pdt)
    if key == "ritz_t":    # a constraint, for the two-term NTK case
        kw["constraints"] = lambda f, x, t: f(ZERO, ZERO)
    extra = dict(device="cpu") if pkg == "torch" else {}
    return pdt.Solver(kw.pop("equation"), seed=0, **kw, **extra)


def _fit_kwargs(pkg, kw):
    kw = dict(kw)
    if kw.get("sampler") == "scipy":
        kw["sampler"] = (jpdt if pkg == "jax"
                         else tpdt).samplers.ScipySampler("uniform")
    if kw.get("criterion") == "callable_l1":
        kw["criterion"] = ((lambda a, b: jnp.mean(jnp.abs(a - b)))
                           if pkg == "jax" else
                           (lambda a, b: torch.mean(torch.abs(a - b))))
    return kw


@pytest.mark.parametrize("key,kw,match", INVALID,
                         ids=[f"{k}-{'-'.join(map(str, kw))}-{m[:12]}"
                              for k, kw, m in INVALID])
def test_invalid_options_raise_in_both_packages(key, kw, match):
    for pkg in ("jax", "torch"):
        solver = _invalid_solver(pkg, key)
        with pytest.raises(ValueError, match=match):
            solver.fit(niters=1, batch_size=8, progress=False,
                       **_fit_kwargs(pkg, kw))
        assert solver.losses == []


def test_formulation_is_checked_in_both_packages():
    for pdt, extra in ((jpdt, {}), (tpdt, dict(device="cpu"))):
        with pytest.raises(ValueError, match="formulation"):
            pdt.Solver(lambda f, x: f, ndims=1, formulation="weak", **extra)


def test_variational_plan_carries_first_order_taps_only():
    # tests/test_variational.py:35-53: a second-order problem whose energy
    # takes first derivatives plans order-1 taps, the same as JAX's plan.
    def energy(pdt):
        def e(f, x, y):
            src = (2 * np.pi ** 2 * pdt.sin(np.pi * x)
                   * pdt.sin(np.pi * y))
            return 0.5 * (pdt.D(f, x) ** 2 + pdt.D(f, y) ** 2) - src * f
        return e

    kw = dict(ndims=2, seed=0, boundary_condition=0, layout="fa fa f",
              features=[24, 24, 1], activation="Tanh",
              formulation="variational")
    ts = tpdt.Solver(energy(tpdt), device="cpu", **kw)
    js = jpdt.Solver(energy(jpdt), **kw)
    assert ts._plan_ok and ts._plan_derivs == js._plan_derivs
    assert max(len(d) for d in ts._plan_derivs) == 1
