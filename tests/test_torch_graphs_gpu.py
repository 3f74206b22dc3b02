"""Fits on the card through captured CUDA graphs against the same fits run
eagerly (``Solver._capture_steps = False``).  Every test here needs a CUDA
card and skips without one.  The file imports no JAX, so it also runs where
only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_graphs_gpu.py

Graph and eager run the same kernels on the same inputs in the same order,
so their losses agree to f32 rounding: each pair is held to rtol 1e-5 over
its first 20 steps (where Adam's steps are still large and any
disagreement would show) and to rtol 1e-3 at its end.
"""

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
