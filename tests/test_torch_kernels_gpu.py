"""The CUDA kernels of pydens_tpu_torch against their plain PyTorch
versions, on the card.  Every test here needs a CUDA card and skips
without one.  The file imports no JAX, so it also runs where only the port
is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from pydens_tpu_torch.models.layout import make_layout_network
from pydens_tpu_torch.ops import fused_mlp, fused_taylor

POISSON_CLOSURE = [(0,), (1,), (0, 0), (1, 1)]
HEAT_CLOSURE = [(0,), (1,), (2,), (0, 0), (1, 1)]   # 2D + t: 6 streams
M = fused_taylor._TILE_POINTS
README_CHAIN = ("fa fa fa f", [10, 12, 15, 1], "Tanh", 2, POISSON_CLOSURE)
WIDE_CHAIN = ("fa fa fa f", [64, 64, 64, 1], "Tanh", 2, POISSON_CLOSURE)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


def _points(n):
    """``n``, or for "grid" two full waves of persistent blocks plus one
    point: 2 * (SM count) * TILE_POINTS + 1."""
    if n == "grid":
        return 2 * torch.cuda.get_device_properties(
            0).multi_processor_count * M + 1
    return n


@pytest.mark.gpu
@pytest.mark.parametrize("layout,features,act,in_dim,closure,n", [
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 2, POISSON_CLOSURE, 100),
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 2, POISSON_CLOSURE, 1000),
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 2, POISSON_CLOSURE, 65537),
    ("fafaf", [12, 10, 1], "Tanh", 1, [(0,)], 400),     # w2: first order only
    ("fa fa f", [16, 16, 1], "Sigmoid", 3, [(0,), (2,), (0, 2)], 257),
    ("fa fa f", [16, 16, 1], "Sin", 2, [(0,), (1,), (0, 0), (0, 1)], 96),
    # Ragged n around the tile and the grid of persistent blocks.
    (*README_CHAIN, 1),
    (*README_CHAIN, M - 1),
    (*README_CHAIN, M + 1),
    (*README_CHAIN, "grid"),
    (*WIDE_CHAIN, "grid"),
    (*WIDE_CHAIN, 262144),
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 3, HEAT_CLOSURE, 20000),
    # The tutorials' Sigmoid shapes at the batches of their fits: w3 (heat
    # 2D+t with a parameter column, 6 streams), w4 (first order with a
    # parameter column, 2 streams) and w5 (first order, one input, 2
    # streams; 500 points frozen, then 100 with the constraint).
    ("fafaf", [30, 40, 1], "Sigmoid", 4, HEAT_CLOSURE, 1500),
    ("fafaf", [20, 30, 1], "Sigmoid", 2, [(0,)], 700),
    ("fafaf", [20, 30, 1], "Sigmoid", 1, [(0,)], 500),
    ("fafaf", [20, 30, 1], "Sigmoid", 1, [(0,)], 100),
])
def test_taylor_kernels_match_plain_on_cuda(layout, features, act, in_dim,
                                            closure, n):
    # Values rtol/atol 2e-5; gradients rtol 2e-3 / atol 2e-5 against the
    # plain autograd path on the card; the backward is bitwise repeatable.
    _require_cuda()
    n = _points(n)
    dev = torch.device("cuda")
    net = make_layout_network(layout, features, act, in_dim=in_dim,
                              device=dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    plan = fused_taylor.TaylorPlan(net.tokens, net.activations, closure,
                                   net.layer_shapes, in_dim)
    with torch.no_grad():
        packed = fused_taylor.pack_weights(net.params(), net.layer_names)
    x = torch.rand(n, in_dim, device=dev, generator=torch.Generator(dev)
                   .manual_seed(1))
    out = fused_taylor.fused_taylor_forward(packed, x, plan)
    ref = fused_taylor.fused_taylor_forward_plain(packed, x, plan)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    g = 2.0 * ref / ref.numel()   # cotangent of mean(out ** 2)
    dp, dx = fused_taylor.fused_taylor_backward(packed, x, g, plan)
    rdp, rdx = fused_taylor.fused_taylor_backward_plain(packed, x, g, plan)
    torch.testing.assert_close(dp, rdp, rtol=2e-3, atol=2e-5)
    torch.testing.assert_close(dx, rdx, rtol=2e-3, atol=2e-5)
    dp2, dx2 = fused_taylor.fused_taylor_backward(packed, x, g, plan)
    assert torch.equal(dp, dp2) and torch.equal(dx, dx2)


@pytest.mark.gpu
def test_taylor_backward_memory_does_not_grow_with_n():
    # 64-wide chain, 262,144 points: beyond its inputs and outputs the
    # backward allocates only its workspace, which is sized by the grid
    # (TaylorPlan.backward_workspace, about 25 MB on an H100) and stays
    # under 64 MiB; saving every op's input state per point would take
    # 2.3 GB at this n.
    _require_cuda()
    layout, features, act, in_dim, closure = WIDE_CHAIN
    dev = torch.device("cuda")
    net = make_layout_network(layout, features, act, in_dim=in_dim,
                              device=dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    plan = fused_taylor.TaylorPlan(net.tokens, net.activations, closure,
                                   net.layer_shapes, in_dim)
    with torch.no_grad():
        packed = fused_taylor.pack_weights(net.params(), net.layer_names)
    n = 262144
    gen = torch.Generator(dev).manual_seed(1)
    x = torch.rand(n, in_dim, device=dev, generator=gen)
    g = torch.randn(n, plan.n_streams * plan.out_dim, device=dev,
                    generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dp, dx = fused_taylor.fused_taylor_backward(packed, x, g, plan)
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base
             - 4 * (dp.numel() + dx.numel()))
    _, save_floats, partial_floats = plan.backward_workspace(
        n, torch.cuda.get_device_properties(0).multi_processor_count)
    assert extra <= 4 * (save_floats + partial_floats) + 2**20
    assert extra < 64 * 2**20


@pytest.mark.gpu
@pytest.mark.parametrize("ic", [False, True])
def test_solver_loss_through_kernels_matches_nested_gradients_on_cuda(ic):
    # The README loss (and the w2 IC loss) on the card: the Taylor plan
    # through FusedTaylor against the nested autograd.grad path — loss rtol
    # 2e-5, gradients rtol 2e-3 / atol 2e-5 — with both kernels launched.
    _require_cuda()
    import numpy as np
    from pydens_tpu_torch import D, Solver
    from pydens_tpu_torch.utils.criteria import mse_loss

    if ic:
        def eq(f, x):
            return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)
        kw = dict(ndims=1, initial_condition=.5, activation="Tanh",
                  layout="fafaf", features=[12, 10, 1])
    else:
        def eq(f, x, y):
            return D(D(f, x), x) + D(D(f, y), y) - 5 * torch.sin(
                np.pi * (x + y))
        kw = dict(ndims=2, boundary_condition=1, layout="fa fa fa f",
                  activation="Tanh", units=[10, 12, 15, 1])
    solver = Solver(eq, device="cuda", **kw)
    pts = torch.rand(100, solver.model.total, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(3))
    results = []
    for use_plan in (True, False):
        loss_fn = solver._build_loss_fn((("equation", 1.0),), mse_loss,
                                        use_plan=use_plan)
        theta = loss_fn.spec.flatten(solver.model.params).detach()
        theta.requires_grad_(True)
        fwd = fused_taylor.fused_taylor_forward.launches
        bwd = fused_taylor.fused_taylor_backward.launches
        loss = loss_fn(theta, pts)
        grad, = torch.autograd.grad(loss, theta)
        launched = (fused_taylor.fused_taylor_forward.launches - fwd,
                    fused_taylor.fused_taylor_backward.launches - bwd)
        assert launched == ((1, 1) if use_plan else (0, 0))
        results.append((loss.detach(), grad))
    (pl, pg), (fl, fg) = results
    torch.testing.assert_close(pl, fl, rtol=2e-5, atol=0)
    torch.testing.assert_close(pg, fg, rtol=2e-3, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("layout,features,act,in_dim,n", [
    ("fa fa f", [32, 32, 1], "Tanh", 3, 2000),
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 3, 2000),
    ("faR fa fa+ f", [16, 16, 16, 1], "Tanh", 3, 2000),
    ("fafaf", [30, 40, 1], "Sigmoid", 4, 2000),     # w3's layout
    ("fafaf", [20, 30, 1], "Sigmoid", 2, 2000),     # w4's layout
    # The tutorials' predict calls, at their own points.
    ("fafaf", [12, 10, 1], "Tanh", 1, 100),         # w2
    ("fafaf", [30, 40, 1], "Sigmoid", 4, 8),        # w3
    ("fafaf", [20, 30, 1], "Sigmoid", 2, 60),       # w4
    ("fafaf", [20, 30, 1], "Sigmoid", 1, 8),        # w5
])
def test_mlp_kernel_matches_plain_on_cuda(layout, features, act, in_dim, n):
    # rtol/atol 2e-5 against the plain version on the card.
    _require_cuda()
    dev = torch.device("cuda")
    net = make_layout_network(layout, features, act, in_dim=in_dim,
                              device=dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    plan = fused_mlp.MlpPlan(net.tokens, net.activations, net.layer_shapes,
                             in_dim)
    x = torch.randn(n, in_dim, device=dev)
    with torch.no_grad():
        packed = fused_taylor.pack_weights(net.params(), net.layer_names)
        out = fused_mlp.fused_mlp_forward(packed, x, plan)
        ref = fused_mlp.fused_mlp_forward_plain(packed, x, plan)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
