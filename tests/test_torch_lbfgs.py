"""L-BFGS (optimizer='LBFGS') of pydens_tpu_torch against optax.lbfgs as
pydens_tpu builds it (learning_rate=None, the zoom linesearch with the
initial guess 'one'): 10 updates of a quadratic and of Rosenbrock's
function (whose steps zoom) against the jitted optax update, 10 one-step
w2 fits against the JAX Solver's on a fixed batch, the gate, and the
tests/test_lbfgs.py cases.  The finishers' loop contracts (reuse, resume
from a checkpoint, until_loss) for L-BFGS and LM close the file."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.utils.criteria import mse_loss
from pydens_tpu_torch.utils.optimizers import LBFGS, resolve_optimizer

from one_thread import one_thread  # noqa: F401

RTOL = 1e-4


def _quadratic(lib):
    rng = np.random.default_rng(0)
    m = rng.normal(size=(12, 12)).astype(np.float32)
    a = (m @ m.T / 12 + 0.1 * np.eye(12)).astype(np.float32)
    c = rng.normal(size=12).astype(np.float32)
    A, C = (jnp.asarray(a), jnp.asarray(c)) if lib is jnp else (
        torch.from_numpy(a), torch.from_numpy(c))
    return (lambda x: 0.5 * x @ (A @ x) - C @ x), rng.normal(
        size=12).astype(np.float32)


def _rosenbrock(lib):
    def f(x):
        return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                       + (1 - x[:-1]) ** 2)
    return f, np.array([-1.2, 1.0], np.float32)


def _port_step(opt, theta, state, ls, value_and_grad):
    """One L-BFGS step of the port, the host reading the linesearch's flag
    as the Solver does."""
    value, grad = value_and_grad(theta)
    opt.begin(theta, value, grad, state, ls)
    opt.trial(theta, state, ls, value_and_grad)
    while bool(ls["active"]):
        opt.trial(theta, state, ls, value_and_grad)


def _torch_value_and_grad(f):
    def vg(x):
        x = x.detach().requires_grad_(True)
        v = f(x)
        return v.detach(), torch.autograd.grad(v, x)[0]
    return vg


@pytest.mark.parametrize("problem,steps", [(_quadratic, 10),
                                           (_rosenbrock, 5)],
                         ids=["quadratic", "rosenbrock"])
def test_lbfgs_update_matches_jitted_optax(problem, steps):
    # Updates from the same start: the stepsize and the linesearch's
    # iteration count of every step, and theta after it, rtol 1e-4 (f32,
    # other summation order; the counts equal).  Rosenbrock's first step
    # zooms; after its fifth the two f32 trajectories drift apart by more
    # than 1e-4 on that ill-conditioned valley, so it stops there.
    jf, x0 = problem(jnp)
    tf, _ = problem(torch)
    opt = optax.lbfgs()
    vg = jax.jit(jax.value_and_grad(jf))
    update = jax.jit(lambda g, s, p, v: opt.update(g, s, p, value=v, grad=g,
                                                   value_fn=jf))
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0.copy())
    jstate = opt.init(jx)
    port = LBFGS()
    state, ls = port.init(tx), port.scratch(tx)
    counts = []
    for _ in range(steps):
        v, g = vg(jx)
        upd, jstate = update(g, jstate, jx, v)
        jx = optax.apply_updates(jx, upd)
        _port_step(port, tx, state, ls, _torch_value_and_grad(tf))
        zoom = jstate[-1]
        counts.append(int(zoom.info.num_linesearch_steps))
        assert int(state["num_linesearch_steps"]) == counts[-1]
        np.testing.assert_allclose(float(state["learning_rate"]),
                                   float(zoom.learning_rate), rtol=RTOL)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL,
                                   atol=1e-6)
    assert int(state["count"]) == steps
    if problem is _rosenbrock:
        assert max(counts) > 1


class _Fixed:
    def __init__(self, pts):
        self.pts = pts

    def sample(self, size):
        return self.pts[:size]


def _w2(pdt):
    def ode(f, x):
        return pdt.D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x)
    return ode, dict(ndims=1, initial_condition=.5, activation="Tanh",
                     layout="fafaf", features=[12, 10, 1])


def test_lbfgs_w2_fit_steps_match_jax():
    # The w2 loss on 256 fixed points from the JAX solver's theta after
    # 300 Adam steps (the finishing phase's start; its first L-BFGS step
    # zooms): ten one-step fits (the first fresh, then optimizer=None) in
    # each package; after each, the stepsize, the linesearch's count and
    # theta, rtol 1e-4 (theta atol 1e-5), and the losses rtol 1e-4.
    pts = np.random.default_rng(5).uniform(size=(256, 1)).astype(np.float32)
    eq, kw = _w2(jpdt)
    js = jpdt.Solver(eq, seed=0, **kw)
    js.fit(niters=300, batch_size=256, lr=0.02, progress=False)
    eq, kw = _w2(tpdt)
    ts = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    spec = ts._build_loss_fn((("equation", 1.0),), mse_loss).spec
    fit = dict(niters=1, batch_size=256, resample=False, progress=False,
               sampler=_Fixed(pts))
    counts = []
    for k in range(10):
        opt = "LBFGS" if k == 0 else None
        js.fit(optimizer=opt, **fit)
        ts.fit(optimizer=opt, **fit)
        zoom = js._opt_state[-1]
        counts.append(int(zoom.info.num_linesearch_steps))
        assert int(ts._opt_state["num_linesearch_steps"]) == counts[-1]
        np.testing.assert_allclose(float(ts._opt_state["learning_rate"]),
                                   float(zoom.learning_rate), rtol=RTOL)
        np.testing.assert_allclose(
            spec.flatten(ts.model.params).detach().numpy(),
            np.asarray(ravel_pytree(js.model.params)[0]), rtol=RTOL,
            atol=1e-5)
    np.testing.assert_allclose(ts.losses, js.losses[300:], rtol=RTOL)
    assert max(counts) > 1 and ts.losses[-1] < 0.7 * ts.losses[0]


def test_closed_gate_makes_the_step_a_no_op():
    # gate=False at begin (the guard tripped): every trial still runs, and
    # theta and every state buffer stay bitwise the same.
    f, x0 = _rosenbrock(torch)
    vg = _torch_value_and_grad(f)
    opt = LBFGS(memory_size=3)
    theta = torch.from_numpy(x0.copy())
    state, ls = opt.init(theta), opt.scratch(theta)
    _port_step(opt, theta, state, ls, vg)
    before = theta.clone(), {k: v.clone() for k, v in state.items()}
    value, grad = vg(theta)
    opt.begin(theta, value, grad, state, ls, gate=torch.tensor(False))
    trials = 0
    while bool(ls["active"]):
        opt.trial(theta, state, ls, vg)
        trials += 1
    assert trials >= 1 and torch.equal(theta, before[0])
    assert all(torch.equal(state[k], v) for k, v in before[1].items())


def test_lbfgs_finishing_phase_improves_loss():
    # tests/test_lbfgs.py: 300 Adam steps, then a full-batch L-BFGS polish
    # to its bounds.  The bounds hold for the Adam phase of the JAX test's
    # seed (on the CPU, pydens_tpu's seeds 0, 1 and 2 end at 4.6e-5,
    # 1.04e-4 and 1.67e-4), so the port polishes from that phase's theta
    # on 512 fixed points.
    eq, kw = _w2(jpdt)
    js = jpdt.Solver(eq, seed=0, **kw)
    js.fit(niters=300, batch_size=512, lr=0.02, progress=False)
    eq, kw = _w2(tpdt)
    solver = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    solver.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                          js.model.params)))
    adam_loss = js.losses[-1]
    pts = np.random.default_rng(0).uniform(size=(512, 1)).astype(np.float32)
    solver.fit(niters=100, batch_size=512, optimizer="LBFGS",
               resample=False, progress=False, sampler=_Fixed(pts))
    assert solver.losses[-1] < adam_loss
    assert solver.losses[-1] < 1e-4
    xs = np.linspace(0, 1, 100)
    err = np.max(np.abs(solver.predict(xs).ravel()
                        - (np.sin(2 * np.pi * xs) + .5)))
    assert err < 0.02
    (step,) = solver._step_cache.values()
    # Each step took at least its first trial.
    assert int(step.live) >= 100 and step.eager_steps == 100


def test_lbfgs_memory_size_kwargs_and_warnings():
    eq, kw = _w2(tpdt)
    solver = tpdt.Solver(eq, ndims=1, seed=0, device="cpu")
    solver.fit(niters=5, batch_size=64, optimizer="LBFGS", resample=False,
               memory_size=5, progress=False)
    assert len(solver.losses) == 5
    assert solver._opt_state["diff_params_memory"].shape[0] == 5
    assert resolve_optimizer("LBFGS", 0.005, {"history_size": 3}
                             ).memory_size == 3
    assert resolve_optimizer("lbfgs", 0.005, {}).memory_size == 10
    with pytest.warns(UserWarning, match="lr argument is ignored"):
        resolve_optimizer("LBFGS", 0.1, {})
    with pytest.raises(ValueError, match="memory_size"):
        LBFGS(memory_size=0)
    opt = LBFGS(memory_size=4)
    assert resolve_optimizer(opt, 0.005, {}) is opt


def _finisher_fit(solver, niters, pts, **kw):
    solver.fit(niters=niters, batch_size=len(pts), resample=False,
               progress=False, sampler=_Fixed(pts), **kw)


@pytest.mark.parametrize("optimizer", ["LBFGS", "LM"])
def test_finisher_reuse_and_checkpoint_resume(optimizer, tmp_path):
    # fit(optimizer=None) continues the state; a checkpoint saved after a
    # fit and loaded into a fresh solver continues the saver's next fit
    # bit for bit (the optimizer state grafted onto the next fit).
    eq, kw = _w2(tpdt)
    pts = np.random.default_rng(2).uniform(size=(64, 1)).astype(np.float32)
    a = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    _finisher_fit(a, 3, pts, optimizer=optimizer)
    path = str(tmp_path / "ckpt.npz")
    a.save(path)
    _finisher_fit(a, 3, pts, optimizer=None)
    b = tpdt.Solver(eq, seed=1, device="cpu", **kw)
    b.load(path)
    _finisher_fit(b, 3, pts, optimizer=optimizer)
    assert b.losses == a.losses and len(a.losses) == 6
    c = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    _finisher_fit(c, 6, pts, optimizer=optimizer)
    assert c.losses == a.losses


@pytest.mark.parametrize("optimizer", ["LBFGS", "LM"])
def test_finisher_until_loss_and_guard_stop(optimizer):
    # until_loss stops at the first loss at or below tol; the step that
    # reaches it is kept and later ones are not taken (history's
    # converged_at), as for the first-order optimizers.
    eq, kw = _w2(tpdt)
    pts = np.random.default_rng(3).uniform(size=(64, 1)).astype(np.float32)
    probe = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    _finisher_fit(probe, 8, pts, optimizer=optimizer, stop_on_nan=False)
    losses = np.asarray(probe.losses)
    k = int(np.argmax(losses < losses[0]))   # the first that fell below
    tol = float(np.sqrt(losses[k] * min(losses[:k])))
    s = tpdt.Solver(eq, seed=0, device="cpu", **kw)
    _finisher_fit(s, 8, pts, optimizer=optimizer, until_loss=tol)
    assert s.history[-1]["converged_at"] == k
    assert s.losses == probe.losses[:k + 1]
