"""Fits on the card through captured CUDA graphs against the same fits run
eagerly (``Solver._capture_steps = False``).  Every test here needs a CUDA
card and skips without one.  The file imports no JAX, so it also runs where
only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_graphs_gpu.py

Graph and eager run the same kernels on the same inputs in the same order,
so their losses agree to f32 rounding: each pair is held to rtol 1e-5 over
its first 20 steps (where Adam's steps are still large and any
disagreement would show) and to rtol 1e-3 at its end.  The collocation
options (adaptive, RBA, causal, grad and NTK balancing) are held so too;
annealing causal eps replays the captured graph, and the rebalance graph
replays 10 times a fit.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from pydens_tpu_torch import D, NS, Solver, V
from pydens_tpu_torch.ops import fused_taylor
from pydens_tpu_torch.utils import schedules


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs exist only there")


def _poisson():
    def pde(f, x, y):
        return D(D(f, x), x) + D(D(f, y), y) - 5 * torch.sin(np.pi * (x + y))
    return pde, dict(ndims=2, boundary_condition=1, layout="fa fa fa f",
                     activation="Tanh", units=[10, 12, 15, 1])


def _heat():
    def pde(f, x, y, t, a):
        return D(D(f, x), x) + D(D(f, y), y) - a * D(f, t)
    return pde, dict(ndims=3, nparams=1,
                     initial_condition=lambda x, y: 10 * x * y * (1 - x)
                     * (1 - y), boundary_condition=0, layout="fafaf",
                     features=[30, 40, 1], activation="Sigmoid")


def _inverse():
    def odevar(f, x):
        return (D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)
                + V("new_var", data=np.array([1.0])))
    return odevar, dict(ndims=1, initial_condition=1,
                        constraints=lambda f, x: f(np.array([0.5])))


def _skip():
    # A skip layout is outside the fused kernel's scope: the plan runs the
    # generic Taylor traversal.
    def pde(f, x, y):
        return D(D(f, x), x) + D(D(f, y), y) - 1.0
    return pde, dict(ndims=2, boundary_condition=lambda x, y: x * y,
                     layout="faR fa fa+ f", activation="Tanh",
                     units=[16, 16, 16, 1])


def _pair(make, fits, hook=None):
    """The same fits on two solvers of one seed: graphs and eager."""
    out = []
    for capture in (True, False):
        eq, kw = make()
        s = Solver(eq, seed=0, device="cuda", **kw)
        s._capture_steps = capture
        for i, fit in enumerate(fits):
            if hook is not None:
                hook(s, i)
            s.fit(progress=False, **fit)
        out.append(s)
    return out


def _assert_agree(graph, eager):
    g, e = np.asarray(graph.losses), np.asarray(eager.losses)
    assert g.shape == e.shape and np.isfinite(g).all()
    np.testing.assert_allclose(g[:20], e[:20], rtol=1e-5)
    np.testing.assert_allclose(g[-1], e[-1], rtol=1e-3)
    steps = [s for s in graph._step_cache.values()]
    assert sum(s.replays for s in steps) == len(g) - len(steps)
    assert all(s.graph is not None for s in steps)
    assert all(s.graph is None and s.replays == 0
               for s in eager._step_cache.values())


@pytest.mark.gpu
@pytest.mark.parametrize("fast_taps", ["auto", False],
                         ids=["plan", "nested"])
def test_w1_graph_matches_eager(fast_taps):
    _require_cuda()
    fw = fused_taylor.fused_taylor_forward.launches
    graph, eager = _pair(_poisson, [dict(niters=300, batch_size=100,
                                         chunk_size=100,
                                         fast_taps=fast_taps)])
    _assert_agree(graph, eager)
    if fast_taps == "auto":
        # The graph fit called the forward kernel's wrapper twice (its
        # warm-up and its capture), the eager fit once a step.
        assert fused_taylor.fused_taylor_forward.launches - fw == 2 + 300


@pytest.mark.gpu
def test_w3_six_streams_graph_matches_eager():
    _require_cuda()
    sampler = (NS("u", dim=2, seed=0) & NS("u", low=0, high=.5, seed=1)
               & NS("u", low=.1, high=4, seed=2))
    graph, eager = _pair(_heat, [dict(niters=120, batch_size=1500, lr=0.001,
                                      sampler=sampler, chunk_size=50)])
    _assert_agree(graph, eager)


@pytest.mark.gpu
def test_w5_constraint_and_freeze_graph_matches_eager():
    # A constraint at numpy points (staged on the card by the warm-up) and
    # a frozen variable (the gradient mask), then both phases' graphs.
    _require_cuda()

    def hook(s, i):
        if i == 0:
            s.model.freeze_trainable(variables=("new_var",))
        else:
            s.model.unfreeze_trainable(variables=["new_var"])
    graph, eager = _pair(_inverse, [
        dict(niters=100, batch_size=500, lr=0.1),
        dict(niters=100, batch_size=100, lr=0.1,
             loss_terms=["equation", "constraint_0"])], hook)
    _assert_agree(graph, eager)
    assert len(graph._step_cache) == 2
    assert graph.params["variables"]["new_var"].item() != 1.0


@pytest.mark.gpu
def test_plain_traversal_graph_matches_eager():
    _require_cuda()
    graph, eager = _pair(_skip, [dict(niters=120, batch_size=256,
                                      chunk_size=40)])
    assert graph.model._fused_taylor_plan(
        graph.model.plan_closure(graph._plan_derivs)) is None
    _assert_agree(graph, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer,kw", [
    ("SGD", dict(momentum=0.9)), ("AdamW", {}), ("RMSprop", {}),
    ("Adam", dict(lr=schedules.cosine_decay_schedule(0.01, 200)))])
def test_optimizers_and_schedules_graph_matches_eager(optimizer, kw):
    _require_cuda()
    kw = dict(dict(lr=0.005), **kw)
    graph, eager = _pair(_poisson, [dict(niters=200, batch_size=100,
                                         optimizer=optimizer, **kw)])
    _assert_agree(graph, eager)


@pytest.mark.gpu
def test_cached_graph_is_replayed_by_later_fits():
    # A second fit of the same configuration, fit(optimizer=None) and a
    # fit after reset() replay the one graph on the same buffers.
    _require_cuda()
    eq, kw = _poisson()
    s = Solver(eq, seed=0, device="cuda", **kw)
    s.fit(niters=50, batch_size=100, progress=False)
    (step,) = s._step_cache.values()
    graph, theta = step.graph, step.theta.data_ptr()
    s.fit(niters=50, batch_size=100, progress=False)
    s.fit(niters=50, batch_size=100, progress=False, optimizer=None)
    s.reset(seed=0)
    s.fit(niters=50, batch_size=100, progress=False)
    assert list(s._step_cache.values()) == [step] and step.graph is graph
    assert step.theta.data_ptr() == theta
    assert step.eager_steps == 1 and step.replays == 4 * 50 - 1
    fresh = Solver(eq, seed=0, device="cuda", **kw)
    fresh.fit(niters=50, batch_size=100, progress=False)
    np.testing.assert_allclose(s.losses, fresh.losses, rtol=1e-5)


@pytest.mark.gpu
def test_guard_and_until_loss_indices_under_the_graph():
    # lr 30 drives w5 to a non-finite loss; tol between two losses of an
    # eager run stops the graph run at the same index.
    _require_cuda()
    pts = np.random.default_rng(0).uniform(size=(64, 1)).astype(np.float32)

    class Fixed:
        def sample(self, size):
            return pts[:size]

    fit = dict(niters=30, batch_size=64, lr=30.0, sampler=Fixed(),
               resample=False, chunk_size=10)
    with pytest.warns(UserWarning, match="non-finite loss"):
        graph, eager = _pair(_inverse, [fit])
    stop = eager.history[-1]["stopped_on_nan"]
    assert graph.history[-1]["stopped_on_nan"] == stop
    assert len(graph.losses) == len(eager.losses) == stop + 1

    fit = dict(niters=60, batch_size=64, lr=0.05, sampler=Fixed(),
               resample=False, chunk_size=7)
    _, probe = _pair(_inverse, [fit])
    losses = np.asarray(probe.losses)
    run_min = np.minimum.accumulate(losses)
    gaps = run_min[:-1] / losses[1:]
    k = 5 + int(np.argmax(gaps[5:])) + 1
    tol = float(np.sqrt(run_min[k - 1] * losses[k]))
    graph, eager = _pair(_inverse, [dict(fit, until_loss=tol)])
    assert graph.history[-1]["converged_at"] == eager.history[-1][
        "converged_at"]


@pytest.mark.gpu
def test_checkpoint_resume_on_the_card(tmp_path):
    # Saved after a fit, loaded into a fresh solver: its next fit equals
    # the saving solver's next fit (optimizer state and generator state
    # restored; same graphs on both).
    _require_cuda()
    eq, kw = _poisson()
    path = str(tmp_path / "ckpt.npz")
    a = Solver(eq, seed=0, device="cuda", **kw)
    a.fit(niters=100, batch_size=100, progress=False)
    a.save(path)
    a.fit(niters=100, batch_size=100, progress=False, optimizer=None)
    b = Solver(eq, seed=5, device="cuda", **kw)
    b.load(path)
    b.fit(niters=100, batch_size=100, progress=False)
    assert len(b.losses) == 200
    np.testing.assert_allclose(b.losses[100:], a.losses[100:], rtol=1e-5)


@pytest.mark.gpu
def test_schedule_that_reads_the_count_on_the_host_raises():
    # A schedule with a Python branch on the count runs in the eager
    # warm-up step but cannot be captured: the fit raises, naming the
    # reason, does not fall back to the eager loop, and keeps the
    # parameters from before the chunk.
    _require_cuda()
    eq, kw = _poisson()
    s = Solver(eq, seed=0, device="cuda", **kw)
    before = [p.detach().clone() for p in s.model.parameters()]

    def host_schedule(count):
        return 0.01 if float(count) < 5 else 0.001

    with pytest.raises(RuntimeError, match="capture of the fit step failed"):
        s.fit(niters=10, batch_size=100, lr=host_schedule, progress=False)
    (step,) = s._step_cache.values()
    assert step.graph is None and step.eager_steps == 1
    assert step.replays == 0 and s._step_counter == 0 and s.losses == []
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 s.model.parameters()))


def _ode_ic():
    def ode(f, x):
        return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)
    return ode, dict(ndims=1, initial_condition=.5, activation="Tanh",
                     layout="fafaf", features=[12, 10, 1])


def _finisher_pair(make, optimizer, niters, batch, **kw):
    """Adam, then ``optimizer`` on a fixed batch, through graphs and
    eagerly."""
    return _pair(make, [dict(niters=100, batch_size=batch, lr=0.01),
                        dict(niters=niters, batch_size=batch,
                             optimizer=optimizer, resample=False, **kw)])


@pytest.mark.gpu
@pytest.mark.parametrize("make", [_poisson, _ode_ic], ids=["w1", "ode"])
@pytest.mark.parametrize("optimizer", ["LBFGS", "LM"])
def test_finisher_graph_matches_eager(optimizer, make):
    # L-BFGS (a step graph and a trial graph, the host reading the
    # linesearch's flag) and LM (one graph a step, its CG loop a fixed trip
    # count) through graphs against the same fits eagerly: losses rtol 1e-5
    # over the first 20 steps (_assert_agree) and the same number of live
    # linesearch trials / CG iterations.
    _require_cuda()
    fw = fused_taylor.fused_taylor_jvp.launches
    graph, eager = _finisher_pair(make, optimizer,
                                  30 if optimizer == "LBFGS" else 8, 256)
    _assert_agree(graph, eager)
    g, e = (list(s._step_cache.values())[-1] for s in (graph, eager))
    assert int(g.live) == int(e.live) > 0
    if optimizer == "LBFGS":
        assert g.trial_graph is not None or g.trial_replays == 0
    else:
        # The tangent kernel ran: its wrapper counts the eager steps and
        # the graph's capture.
        assert fused_taylor.fused_taylor_jvp.launches > fw


@pytest.mark.gpu
def test_capture_survives_the_collection_of_a_dead_solver():
    # A solver with a captured graph dies in the middle of the next
    # solver's capture: the equation drops the last reference to it there,
    # makes every generation of the cyclic collector due and allocates.
    # (The objects older than the test are frozen and a full collection
    # runs first, so that the oldest generation is not held back by its
    # size.)  No collection may start inside the capture, and the capture
    # succeeds; the dead solver is collected after it.
    _require_cuda()
    eq, kw = _poisson()
    thresholds = gc.get_threshold()
    gc.collect()
    gc.freeze()
    gc.collect()
    try:
        dead = Solver(eq, seed=0, device="cuda", **kw)
        dead.fit(niters=3, batch_size=100, progress=False)
        assert list(dead._step_cache.values())[0].graph is not None
        dead.cycle = dead
        dead.marker = _Marker()
        freed = []
        weakref.finalize(dead.marker, freed.append, True)
        held = [dead]
        del dead
        started = []
        watching = []

        def watch(phase, info):
            if phase == "start" and watching:
                started.append(info["generation"])

        def pde(f, x, y):
            if held and torch.cuda.is_current_stream_capturing():
                held.clear()
                watching.append(True)
                gc.set_threshold(1, 1, 1)
                junk = [[] for _ in range(1000)]
                gc.set_threshold(*thresholds)
                watching.clear()
                del junk
            return eq(f, x, y)

        gc.callbacks.append(watch)
        try:
            s = Solver(pde, seed=0, device="cuda", **kw)
            s.fit(niters=3, batch_size=100, progress=False)
        finally:
            gc.callbacks.remove(watch)
        assert not held, "the equation did not run inside the capture"
        assert started == [], f"collections inside the capture: {started}"
        (step,) = s._step_cache.values()
        assert step.graph is not None and step.eager_steps == 1
        assert step.replays == 2
        assert gc.isenabled()
        gc.collect()
        assert freed == [True]
    finally:
        gc.set_threshold(*thresholds)
        gc.unfreeze()


class _Marker:
    pass


def _wide128():
    eq, kw = _poisson()
    return eq, dict(kw, layout="fa fa f", units=[128, 128, 1])


@pytest.mark.gpu
def test_lm_graph_matches_eager_on_the_128_wide_chain():
    # LM on the 128-wide Poisson chain (which the first tangent kernel did
    # not fit) through its graph against the same fit eagerly: losses rtol
    # 1e-5 over the first steps (_assert_agree), the same live CG
    # iterations, and the tangent kernel ran in both.
    _require_cuda()
    fw = fused_taylor.fused_taylor_jvp.launches
    graph, eager = _finisher_pair(_wide128, "LM", 6, 1024)
    _assert_agree(graph, eager)
    g, e = (list(s._step_cache.values())[-1] for s in (graph, eager))
    assert int(g.live) == int(e.live) > 0
    # Its wrapper counts each CG iteration of every eager step and of the
    # graph's capture.
    assert fused_taylor.fused_taylor_jvp.launches - fw == g.opt.cg_iters * (
        g.eager_steps + 1 + e.eager_steps)
    assert e.eager_steps == 6


@pytest.mark.gpu
def test_masked_linesearch_graph_matches_the_host_driven_one():
    # Every trial in the step graph (no host read) against the step and
    # trial graphs with the host reading the flag: the same losses (rtol
    # 1e-5) and the same live trials.
    _require_cuda()
    runs = []
    for masked in (False, True):
        eq, kw = _ode_ic()
        s = Solver(eq, seed=0, device="cuda", **kw)
        s._masked_linesearch = masked
        s.fit(niters=100, batch_size=256, lr=0.01, progress=False)
        s.fit(niters=30, batch_size=256, optimizer="LBFGS", resample=False,
              progress=False)
        runs.append(s)
    host, masked = runs
    np.testing.assert_allclose(masked.losses, host.losses, rtol=1e-5)
    steps = [list(s._step_cache.values())[-1] for s in runs]
    assert int(steps[0].live) == int(steps[1].live)
    assert steps[1].trial_graph is None and steps[1].replays == 29


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["LBFGS", "LM"])
def test_finisher_fit_runs_no_plain_function(optimizer, monkeypatch):
    # With every *_plain function of the kernels patched to raise, the
    # finisher fit on the card still runs: its steps take only the kernels.
    _require_cuda()
    from pydens_tpu_torch.ops import fused_mlp

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")
    for mod, name in ((fused_taylor, "fused_taylor_forward_plain"),
                      (fused_taylor, "fused_taylor_backward_plain"),
                      (fused_taylor, "fused_taylor_jvp_plain"),
                      (fused_mlp, "fused_mlp_forward_plain")):
        monkeypatch.setattr(mod, name, refuse)
    eq, kw = _poisson()
    s = Solver(eq, seed=0, device="cuda", **kw)
    s.fit(niters=50, batch_size=256, progress=False)
    s.fit(niters=10, batch_size=256, optimizer=optimizer, resample=False,
          progress=False)
    assert np.isfinite(s.losses).all() and len(s.losses) == 60
    assert s.predict(np.zeros((4, 2), np.float32)).shape == (4, 1)


def _stiff():
    # examples/09's stiff source and solver.
    def ode(f, x):
        return D(f, x) - 100 * torch.exp(-2000 * (x - 0.8) ** 2)
    return ode, dict(ndims=1, initial_condition=0.0, activation="Tanh",
                     layout="fafaf", features=[32, 32, 1])


def _heat_1d():
    def heat(f, x, t):
        return D(f, t) - 0.1 * D(D(f, x), x)
    return heat, dict(ndims=2, initial_condition=lambda x: torch.sin(
        np.pi * x), activation="Tanh", layout="fa fa f", features=[16, 16, 1])


def _helmholtz():
    # examples/31 at narrower widths: penalty conditions, three terms.
    zero = np.array([0.0], np.float32)

    def eq(f, x):
        return D(D(f, x), x) + 144.0 * f
    return eq, dict(ndims=1, layout="fa fa f", features=[24, 24, 1],
                    activation="Tanh",
                    constraints=(lambda f, x: f(zero),
                                 lambda f, x: f.grad(zero, wrt=0) - 12.0))


LT3 = {"equation": 1.0, "constraint_0": 1.0, "constraint_1": 1.0}
OPTION_FITS = {
    "adaptive": (_stiff, dict(niters=200, batch_size=128, lr=0.01,
                              adaptive=8, chunk_size=100)),
    "rba": (_stiff, dict(niters=200, batch_size=256, lr=0.01,
                         resample=False, rba=(0.01, 0.99), chunk_size=100)),
    "causal": (_heat_1d, dict(niters=200, batch_size=512, causal=5.0,
                              chunk_size=100)),
    "grad": (_helmholtz, dict(niters=200, batch_size=256, lr=0.002,
                              loss_terms=LT3, loss_balancing=10,
                              chunk_size=100)),
    "ntk": (_helmholtz, dict(niters=200, batch_size=256, lr=0.002,
                             loss_terms=LT3, loss_balancing=("ntk", 10),
                             chunk_size=100)),
}


def _all_steps(solver):
    """Steps run of each kind over the solver's cached fit steps:
    (eager, replays) of the training step and of the rebalance step."""
    steps = list(solver._step_cache.values())
    return (sum(s.eager_steps for s in steps), sum(s.replays for s in steps),
            sum(s.rebalance_eager for s in steps),
            sum(s.rebalance_replays for s in steps))


@pytest.mark.gpu
@pytest.mark.parametrize("option", list(OPTION_FITS))
def test_collocation_option_graph_matches_eager(option):
    # Each option's fit through its graphs against the same fit eagerly:
    # losses rtol 1e-5 over the first 20 steps and 1e-3 at the end; every
    # step ran once, of its kind; balanced weights agree (rtol 1e-3).
    _require_cuda()
    make, fit = OPTION_FITS[option]
    graph, eager = _pair(make, [fit])
    g, e = np.asarray(graph.losses), np.asarray(eager.losses)
    assert g.shape == e.shape == (200,) and np.isfinite(g).all()
    np.testing.assert_allclose(g[:20], e[:20], rtol=1e-5)
    np.testing.assert_allclose(g[-1], e[-1], rtol=1e-3)
    ge, gr, gre, grr = _all_steps(graph)
    assert ge + gr + gre + grr == 200 and gr > 0
    assert _all_steps(eager)[1::2] == (0, 0)
    if "loss_balancing" in fit:
        assert gre + grr == 10 and grr == 9
        np.testing.assert_allclose(graph.history[-1]["balanced_weights"],
                                   eager.history[-1]["balanced_weights"],
                                   rtol=1e-3)


@pytest.mark.gpu
def test_annealing_causal_reuses_the_captured_graph():
    # A new eps is written into the step's buffer: the second fit replays
    # the first fit's graph and captures nothing (the wrappers count
    # captures: no launch), and its losses differ (eps bites).
    _require_cuda()
    eq, kw = _heat_1d()
    s = Solver(eq, seed=0, device="cuda", **kw)
    s.fit(niters=100, batch_size=512, causal=5.0, progress=False)
    (step,) = s._step_cache.values()
    graph = step.graph
    fw = fused_taylor.fused_taylor_forward.launches
    s.fit(niters=100, batch_size=512, causal=50.0, progress=False)
    assert list(s._step_cache.values()) == [step] and step.graph is graph
    assert fused_taylor.fused_taylor_forward.launches == fw
    assert step.eager_steps == 1 and step.replays == 199
    assert float(step.causal_eps) == 50.0
    assert np.isfinite(s.losses).all()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["grad", "ntk"])
def test_rebalance_graph_replays_ten_times_a_fit(mode):
    # The rebalance window covers 10 steps of each fit: the first fit runs
    # its first rebalance eagerly and replays the captured rebalance graph
    # 9 times; a second fit of the same configuration replays it exactly
    # 10 times, from the loss_terms weights again.
    _require_cuda()
    eq, kw = _helmholtz()
    s = Solver(eq, seed=0, device="cuda", **kw)
    fit = dict(niters=120, batch_size=256, lr=0.002, loss_terms=LT3,
               loss_balancing=(mode, 5), chunk_size=60, progress=False)
    s.fit(**fit)
    (step,) = s._step_cache.values()
    assert (step.rebalance_eager, step.rebalance_replays) == (1, 9)
    graph = step.rebalance_graph
    s.fit(**fit)
    assert step.rebalance_graph is graph
    assert (step.rebalance_eager, step.rebalance_replays) == (1, 19)
    assert step.eager_steps == 1 and step.replays == 2 * 110 - 1
    w = s.history[-1]["balanced_weights"]
    assert w[0] == 1.0 and np.all(np.isfinite(w))


# examples/16's adaptive Burgers fit (the modified MLP, 8 candidates a
# point), 60 steps, after ``sys.argv[1]`` first-order backward passes of
# an unrelated graph; prints theta and the losses as hex.
_ORDER_SCRIPT = r"""
import sys
import numpy as np
import torch
from pydens_tpu_torch import D, NumpySampler as NS, Solver, sin

x = torch.linspace(-1, 1, 64, device="cuda", requires_grad=True)
for _ in range(int(sys.argv[1])):
    torch.autograd.grad(torch.tanh(x).pow(3).sum(), x)
torch.cuda.synchronize()


def burgers(f, x, t):
    return D(f, t) + f * D(f, x) - 0.01 / np.pi * D(D(f, x), x)


s = Solver(burgers, ndims=2, seed=0, domain=[(-1.0, 1.0), (0.0, 1.0)],
           initial_condition=lambda x: -sin(np.pi * x), boundary_condition=0,
           arch="modified", features=[20] * 8 + [1], activation="Tanh")
sampler = NS("u", low=-1, high=1, seed=0) & NS("u", low=0, high=1, seed=1)
s.fit(niters=60, batch_size=2048, lr=2e-3, sampler=sampler, adaptive=8,
      chunk_size=20, progress=False)
theta = s._spec().flatten(s.model.params).detach().cpu().numpy()
print(theta.tobytes().hex())
print(np.asarray(s.losses, np.float32).tobytes().hex())
"""


@pytest.mark.gpu
def test_fit_after_first_order_backward_work_is_bitwise_a_fresh_fit(
        tmp_path):
    # The ansatz composes in forward mode (Model.full_taps: nested
    # torch.func.jvp), so no value of a step depends on the order in which
    # the autograd engine runs nodes: examples/16's adaptive fit after
    # 5,000 first-order backward passes in its process equals the fit in
    # a fresh process, theta and the loss history bit for bit (with
    # full_taps's nested autograd.grad, its candidate pool's residuals and
    # so the fit moved with the earlier work).
    _require_cuda()
    import os
    import subprocess
    import sys
    script = tmp_path / "order.py"
    script.write_text(_ORDER_SCRIPT)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    runs = [subprocess.run([sys.executable, str(script), str(reps)],
                           capture_output=True, text=True, env=env,
                           check=True, timeout=600).stdout.split()
            for reps in (0, 5000)]
    assert len(runs[0]) == 2 and runs[0] == runs[1]
