"""The fused Taylor kernels from an embedding's Taylor state, on the card:
Raissi et al.'s Schrodinger PINN at its published widths (4 x 100 Tanh, two
outputs, x periodic, 20,000 points) and a Fourier-feature chain
(examples/21's) held to the plain traversal; the tangent kernel from the
state; the wrapper's counter and the fit span's route attributes; and the
raw-coordinate chain's kernels unchanged by the new operand.  Every test
here needs a CUDA card and skips without one.  The file imports no JAX, so
it also runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_embedded_gpu.py
"""

import numpy as np
import pytest
import torch

from pydens_tpu_torch import D, NumpySampler, Solver, tracing
from pydens_tpu_torch.models.layout import make_layout_network
from pydens_tpu_torch.ops import fused_taylor

POISSON_CLOSURE = [(0,), (1,), (0, 0), (1, 1)]
M = fused_taylor._TILE_POINTS


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


def _nls(f, x, t):
    u, v = f[:, 0:1], f[:, 1:2]
    mag2 = u * u + v * v
    return (D(u, t) + 0.5 * D(D(v, x), x) + mag2 * v,
            -D(v, t) + 0.5 * D(D(u, x), x) + mag2 * u)


def _raissi(**kw):
    """The Schrodinger configuration at its published widths."""
    return Solver(_nls, ndims=2, domain=[(-5.0, 5.0), (0.0, np.pi / 2)],
                  periodic=(0,), periodic_ic_decay=False,
                  initial_condition=lambda x: torch.stack(
                      [2.0 / torch.cosh(x), torch.zeros_like(x)], -1),
                  layout="fa fa fa fa f", activation="Tanh",
                  units=[100, 100, 100, 100, 2], device="cuda", **kw)


def _multiscale():
    """examples/21's Fourier-feature chain: 32 features, 65 inputs."""
    def poisson(f, x):
        return (D(D(f, x), x) + (2 * np.pi) ** 2 * torch.sin(2 * np.pi * x)
                + 0.1 * (16 * np.pi) ** 2 * torch.sin(16 * np.pi * x))
    return Solver(poisson, ndims=1, seed=0, boundary_condition=0,
                  layout="fa fa f", features=[32, 32, 1], activation="Tanh",
                  fourier_features=(32, 8.0), device="cuda")


def _points(solver, n, seed=0):
    lo = torch.tensor([d[0] for d in solver.model.domain])
    hi = torch.tensor([d[1] for d in solver.model.domain])
    u = torch.rand(n, len(lo), generator=torch.Generator().manual_seed(seed))
    return (lo + (hi - lo) * u).to("cuda")


def _loss_and_grad(solver, x, kernels):
    """The equation's MSE and its gradient at the solver's parameters, on
    the kernels' route from the embedding's state or on the plain
    traversal."""
    from pydens_tpu_torch.utils.criteria import mse_loss
    model = solver.model
    model._taylor_kernels = kernels
    model._taylor_plans.clear()
    loss_fn = solver._build_loss_fn((("equation", 1.0),), mse_loss,
                                    use_plan=True)
    theta = loss_fn.spec.flatten(model.params).detach().requires_grad_(True)
    fwd = fused_taylor.fused_taylor_forward.from_embedding
    bwd = fused_taylor.fused_taylor_backward.from_states
    loss = loss_fn(theta, x)
    grad, = torch.autograd.grad(loss, theta)
    return (loss.detach(), grad,
            fused_taylor.fused_taylor_forward.from_embedding - fwd,
            fused_taylor.fused_taylor_backward.from_states - bwd)


@pytest.mark.gpu
@pytest.mark.parametrize("make,n", [(_raissi, 20000), (_multiscale, 4096)])
def test_embedded_chains_match_the_plain_traversal(make, n):
    # Loss rtol 2e-5, gradient rtol 2e-3 / atol 2e-5; one forward from the
    # embedding's state and one backward from the forward's states.
    _require_cuda()
    solver = make()
    x = _points(solver, n)
    kl, kg, fwd, bwd = _loss_and_grad(solver, x, True)
    assert (fwd, bwd) == (1, 1)
    pl, pg, fwd, bwd = _loss_and_grad(solver, x, False)
    assert (fwd, bwd) == (0, 0)
    torch.testing.assert_close(kl, pl, rtol=2e-5, atol=0)
    torch.testing.assert_close(kg, pg, rtol=2e-3, atol=2e-5)


@pytest.mark.gpu
def test_the_tangent_kernel_from_the_state():
    # J v of the Schrodinger chain from the embedding's state against
    # torch.func.jvp of the plain forward (rtol/atol 2e-5); the state has
    # no tangent.
    _require_cuda()
    solver = _raissi()
    model = solver.model
    closure = model.plan_closure(solver._plan_derivs)
    plan = model._fused_taylor_plan(closure)
    assert plan.input_state and plan.in_dim == 3 and plan.n_streams == 4
    x = _points(solver, 20000, seed=1)
    V, taps = model._embed_state(x, closure)
    state = torch.stack([V] + [taps[(d,)] for d in plan.firsts]
                        + [taps[tuple(ab)] for ab in plan.pairs], 1)
    packed = fused_taylor.pack_weights(model.network_params(),
                                       model.net.dense_names).detach()
    v = torch.randn(plan.n_params, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(2))
    out, tout = fused_taylor.fused_taylor_jvp(packed, state, v, plan)
    ref, tref = fused_taylor.fused_taylor_jvp_plain(packed, state, v, plan)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(tout, tref, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["Adam", "LM"])
def test_a_fit_reads_the_kernel_route(optimizer):
    # Solver.fit of the Schrodinger configuration, through captured graphs:
    # every forward wrapper call from the embedding's state, every
    # backward from the forward's states (LM: the tangent kernel too), and
    # the pydens.fit span's taylor_kernels > 0 with taylor_plain 0.
    _require_cuda()
    solver = _raissi(seed=1)
    sampler = (NumpySampler("u", low=-5.0, high=5.0)
               & NumpySampler("u", low=0.0, high=np.pi / 2))
    kw = (dict(optimizer="LM", cg_iters=4, batch_size=2048)
          if optimizer == "LM" else dict(batch_size=20000))
    counters = (fused_taylor.fused_taylor_forward,
                fused_taylor.fused_taylor_backward,
                fused_taylor.fused_taylor_jvp)
    before = [(c.launches, getattr(c, "from_embedding", 0),
               getattr(c, "from_states", 0)) for c in counters]
    with tracing.recording() as kept:
        solver.fit(niters=3, sampler=sampler, resample=False,
                   progress=False, **kw)
    (f0, e0, _), (b0, _, s0), (j0, _, _) = before
    fwd, bwd, jvp = counters
    assert fwd.launches > f0 and fwd.from_embedding - e0 == fwd.launches - f0
    assert bwd.launches > b0 and bwd.from_states - s0 == bwd.launches - b0
    assert (jvp.launches > j0) == (optimizer == "LM")
    root, = [s for s in kept if s.name == "pydens.fit"]
    assert root.attrs["taylor_kernels"] > 0
    assert root.attrs["taylor_plain"] == 0
    assert np.isfinite(solver.losses).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65537, 100])
def test_the_raw_chain_is_unchanged_by_the_input_state(n):
    # The 64-wide raw chain (and the README's batch size): its forward and
    # backward from x equal, bit for bit, what the kernels give from the
    # same start handed over as an input state (V = x, T_d = e_d, S = 0):
    # the streams, the states of every point (the last tile's padding
    # differs: an input state pads with 0 in every stream, x with x = 0),
    # d packed recomputing and from the states, and d x the state
    # cotangent's V rows.
    _require_cuda()
    net = make_layout_network("fa fa fa f", [64, 64, 64, 1], "Tanh",
                              in_dim=2)
    net.reset_parameters(torch.Generator().manual_seed(0))
    args = (net.tokens, net.activations, POISSON_CLOSURE, net.layer_shapes,
            2)
    plan = fused_taylor.TaylorPlan(*args)
    splan = fused_taylor.TaylorPlan(*args, input_state=True)
    packed = fused_taylor.pack_weights(net.params(),
                                       net.layer_names).detach().cuda()
    gen = torch.Generator("cuda").manual_seed(3)
    x = torch.rand(n, 2, device="cuda", generator=gen)
    seed = torch.zeros(n, plan.n_streams, 2, device="cuda")
    seed[:, 0] = x
    for i, d in enumerate(plan.firsts):
        seed[:, 1 + i, d] = 1.0
    g = torch.randn(n, plan.n_streams * plan.out_dim, device="cuda",
                    generator=gen)
    out, states = fused_taylor.fused_taylor_forward(packed, x, plan, True)
    sout, sstates = fused_taylor.fused_taylor_forward(packed, seed, splan,
                                                      True)
    points = torch.arange(states.shape[1] * M, device="cuda").view(
        1, -1, 1, M) < n
    assert torch.equal(out, sout)
    assert torch.equal(states * points, sstates * points)
    for kept, skept in ((None, None), (states, sstates)):
        dp, dx = fused_taylor.fused_taylor_backward(packed, x, g, plan, kept)
        sdp, sds = fused_taylor.fused_taylor_backward(packed, seed, g, splan,
                                                      skept)
        assert torch.equal(dp, sdp) and torch.equal(dx, sds[:, 0])
