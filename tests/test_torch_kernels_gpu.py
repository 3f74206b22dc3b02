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
from pydens_tpu_torch.ops._build import load_library

POISSON_CLOSURE = [(0,), (1,), (0, 0), (1, 1)]
HEAT_CLOSURE = [(0,), (1,), (2,), (0, 0), (1, 1)]   # 2D + t: 6 streams
M = fused_taylor._TILE_POINTS
MLP_TILE = fused_mlp.TILES[0]
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
    # Two outputs (examples/07's oscillator system at its Adam and L-BFGS
    # batches) and the second-IC wave's chain (5 streams).
    ("fa fa f", [32, 32, 2], "Tanh", 1, [(0,)], 512),
    ("fa fa f", [32, 32, 2], "Tanh", 1, [(0,)], 2048),
    ("fa fa f", [32, 32, 1], "Tanh", 2, POISSON_CLOSURE, 1024),
    ("fa fa f", [32, 32, 3], "Sin", 2, POISSON_CLOSURE, 777),
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
@pytest.mark.parametrize("layout,features,act,in_dim,closure,n", [
    (*README_CHAIN, 1024),                        # w1 at the LM batch
    (*README_CHAIN, 1),
    (*README_CHAIN, M + 1),
    (*WIDE_CHAIN, 65537),
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 3, HEAT_CLOSURE, 20000),
    ("fafaf", [12, 10, 1], "Tanh", 1, [(0,)], 512),     # the ODE finisher
    ("fa fa f", [16, 16, 1], "Sigmoid", 3, [(0,), (2,), (0, 2)], 257),
    ("fa fa f", [16, 16, 1], "Sin", 2, [(0,), (1,), (0, 0), (0, 1)], 96),
    ("fafaf", [30, 40, 1], "Sigmoid", 4, HEAT_CLOSURE, 1500),
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 3, HEAT_CLOSURE, 65537),
    ("fa fa f", [128, 128, 1], "Tanh", 2, POISSON_CLOSURE, 65537),
    ("fa fa f", [128, 128, 1], "Tanh", 2, POISSON_CLOSURE, 1000),
    ("fa f", [160, 1], "Tanh", 3, HEAT_CLOSURE, 3001),   # 8 points a tile
    ("fa f", [480, 1], "Sin", 1, [(0,)], 3001),    # 8, weights resident
    ("fa fa f", [480, 8, 1], "Sin", 1, [(0,)], 3001),     # 4 points a tile
])
def test_taylor_jvp_kernel_matches_plain_on_cuda(layout, features, act,
                                                 in_dim, closure, n):
    # The tangent kernel against its plain twin (torch.func.jvp of the
    # plain forward) on the card: streams and tangent rtol/atol 2e-5, at
    # every points-per-tile the plan takes, the weights resident and
    # streamed; a second launch on the same inputs is bitwise equal.  The
    # card holds at least the blocks per SM that the plan's shared memory
    # was sized for (the occupancy calculator: registers too).
    _require_cuda()
    dev = torch.device("cuda")
    net = make_layout_network(layout, features, act, in_dim=in_dim,
                              device=dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    plan = fused_taylor.TaylorPlan(net.tokens, net.activations, closure,
                                   net.layer_shapes, in_dim)
    with torch.no_grad():
        packed = fused_taylor.pack_weights(net.params(), net.layer_names)
    gen = torch.Generator(dev).manual_seed(1)
    x = torch.rand(n, in_dim, device=dev, generator=gen)
    v = torch.randn(plan.n_params, device=dev, generator=gen)
    before = fused_taylor.fused_taylor_jvp.launches
    out, tout = fused_taylor.fused_taylor_jvp(packed, x, v, plan)
    assert fused_taylor.fused_taylor_jvp.launches == before + 1
    ref, tref = fused_taylor.fused_taylor_jvp_plain(packed, x, v, plan)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(tout, tref, rtol=2e-5, atol=2e-5)
    out2, tout2 = fused_taylor.fused_taylor_jvp(packed, x, v, plan)
    assert torch.equal(out, out2) and torch.equal(tout, tout2)
    assert fused_taylor.jvp_blocks_per_sm(plan, x.device) >= \
        plan.jvp_blocks_per_sm


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


# The backward chains of the states path: the README chain, the 64-wide
# chain at 65,537 points, the heat closure (6 streams), Sigmoid, Sin, 128
# wide, and an ensemble of K = 4 (n_members).
STATES_CASES = [
    (*README_CHAIN, 100, 1),
    (*WIDE_CHAIN, 65537, 1),
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 3, HEAT_CLOSURE, 20000, 1),
    ("fa fa f", [16, 16, 1], "Sigmoid", 3, [(0,), (2,), (0, 2)], 257, 1),
    ("fa fa f", [16, 16, 1], "Sin", 2, [(0,), (1,), (0, 0), (0, 1)], 96, 1),
    ("fa fa f", [128, 128, 1], "Tanh", 2, POISSON_CLOSURE, 65537, 1),
    (*WIDE_CHAIN, 20000, 4),
]


@pytest.mark.gpu
@pytest.mark.parametrize("layout,features,act,in_dim,closure,n,n_members",
                         STATES_CASES)
def test_backward_from_states_is_bitwise_the_recompute_on_cuda(
        layout, features, act, in_dim, closure, n, n_members):
    # A forward that keeps its states gives the streams of one that keeps
    # none, bit for bit; the backward from those states gives d packed and
    # d x torch.equal to the backward that recomputes them, both within the
    # gradients' tolerance of the plain twin (rtol 2e-3 / atol 2e-5), and a
    # second launch from the states is bitwise the first; from_states
    # counts the calls given states.
    _require_cuda()
    plan, _, packed = _member_case(layout, features, act, in_dim, closure,
                                   n_members)
    if n_members == 1:
        packed = packed[0].contiguous()
    gen = torch.Generator("cuda").manual_seed(1)
    x = torch.rand((n, in_dim), device="cuda", generator=gen)
    out = fused_taylor.fused_taylor_forward(packed, x, plan)
    kept, states = fused_taylor.fused_taylor_forward(packed, x, plan,
                                                     keep_states=True)
    g = torch.randn(out.shape, device="cuda", generator=gen) / out.numel()
    bwd = fused_taylor.fused_taylor_backward
    calls, reads = bwd.launches, bwd.from_states
    dp, dx = bwd(packed, x, g, plan)
    sp, sx = bwd(packed, x, g, plan, states)
    sp2, sx2 = bwd(packed, x, g, plan, states)
    torch.cuda.synchronize()
    assert (bwd.launches - calls, bwd.from_states - reads) == (3, 2)
    assert torch.equal(out, kept)
    assert torch.equal(dp, sp) and torch.equal(dx, sx)
    assert torch.equal(sp, sp2) and torch.equal(sx, sx2)
    rdp, rdx = fused_taylor.fused_taylor_backward_plain(packed, x, g, plan)
    for a, b in ((dp, rdp), (dx, rdx), (sp, rdp), (sx, rdx)):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-5)


@pytest.mark.gpu
def test_backward_from_states_memory_on_cuda():
    # 64-wide chain, 262,144 points: the forward's states are exactly
    # members x tiles x save_rows x TILE_POINTS floats (1 GB here), and a
    # backward from them allocates only its outputs and its partial
    # gradients, which are sized by the grid; the backward and the forward
    # of the 64-wide chain hold two blocks an SM on the card, registers
    # included (the occupancy calculator).
    _require_cuda()
    layout, features, act, in_dim, closure = WIDE_CHAIN
    plan, _, packed = _member_case(layout, features, act, in_dim, closure, 1)
    packed = packed[0].contiguous()
    n = 262144
    gen = torch.Generator("cuda").manual_seed(1)
    x = torch.rand(n, in_dim, device="cuda", generator=gen)
    plan.device_table(x.device)   # the op table, made once a device
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out, states = fused_taylor.fused_taylor_forward(packed, x, plan,
                                                    keep_states=True)
    torch.cuda.synchronize()
    assert tuple(states.shape) == (1, n // M, plan.save_rows, M)
    assert states.numel() == plan.state_floats(n) == (n // M) * 960 * M
    assert torch.cuda.memory_allocated() - base == 4 * (out.numel()
                                                        + states.numel())
    g = torch.randn(out.shape, device="cuda", generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dp, dx = fused_taylor.fused_taylor_backward(packed, x, g, plan, states)
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base
             - 4 * (dp.numel() + dx.numel()))
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    _, _, partial_floats = plan.backward_workspace(n, sm)
    assert extra <= 4 * partial_floats + 2**20
    lib = load_library()
    assert [lib.pdt_taylor_blocks_per_sm(k, plan.n_params, plan.n_streams,
                                         plan.wmax) for k in range(3)] == \
        [2, 2, 2]


@pytest.mark.gpu
def test_fits_read_the_forward_states_on_cuda(monkeypatch):
    # Where the mechanism engages: in a kernel-route Adam fit and in LM
    # steps every backward wrapper call (eager, warm-up and captures) reads
    # its forward's states; on a card too small to hold them
    # (TaylorPlan.keeps_states) the same fits read none and give the same
    # bits; a forward under no_grad allocates only its streams.
    _require_cuda()
    import numpy as np
    from pydens_tpu_torch import D, Solver

    def eq(f, x, y):
        return D(D(f, x), x) + D(D(f, y), y) - 5 * torch.sin(np.pi * (x + y))

    def fits():
        solver = Solver(eq, ndims=2, boundary_condition=1, seed=0,
                        layout="fa fa fa f", activation="Tanh",
                        units=[10, 12, 15, 1], device="cuda")
        reads = []
        for kw in (dict(niters=30, batch_size=256),
                   dict(niters=3, batch_size=256, optimizer="LM")):
            calls, kept = bwd.launches, bwd.from_states
            solver.fit(progress=False, **kw)
            reads.append((bwd.launches - calls, bwd.from_states - kept))
        theta = torch.cat([p.detach().flatten()
                           for p in solver.model.parameters()])
        return reads, np.asarray(solver.losses), theta

    bwd = fused_taylor.fused_taylor_backward
    reads, losses, theta = fits()
    assert all(calls > 0 and kept == calls for calls, kept in reads), reads
    monkeypatch.setattr(fused_taylor, "_device_bytes", lambda device: 1)
    small, small_losses, small_theta = fits()
    monkeypatch.undo()
    assert [calls for calls, _ in small] == [calls for calls, _ in reads]
    assert all(kept == 0 for _, kept in small), small
    assert np.array_equal(losses, small_losses)
    assert torch.equal(theta, small_theta)
    plan, _, packed = _member_case(*README_CHAIN, 1)
    packed = packed[0].contiguous().requires_grad_(True)
    x = torch.rand(4096, 2, device="cuda")
    plan.device_table(x.device)
    for grad in (False, True):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        with torch.set_grad_enabled(grad):
            v, taps = fused_taylor.fused_taylor_taps(packed, x, plan)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        streams = 4 * x.shape[0] * plan.n_streams * plan.out_dim
        states = 4 * plan.state_floats(x.shape[0]) if grad else 0
        assert held == streams + states, (grad, held, streams, states)
        del v, taps


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
    # The 64-wide chain; ragged n around the tile; an n that takes every
    # persistent block around its loop three times and more; a chain whose
    # state needs the 64-point tile.
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 3, 100000),
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 2, 1),
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 2, MLP_TILE - 1),
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 2, MLP_TILE + 1),
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 3, "passes"),
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 3, "passes"),
    ("faR fa fa+ f", [16, 16, 16, 1], "Sigmoid", 3, "passes"),
    ("fa fa fa f", [128, 128, 128, 1], "Tanh", 3, 5000),
    # Embedded inputs (periodic and Fourier-feature predicts): in_dim 5,
    # 3, 65 (not a multiple of 4) and 21, out_dim 3 and 2.
    ("fa fa fa f", [48, 48, 48, 3], "Tanh", 5, 20000),
    ("fa fa fa f", [48, 48, 48, 2], "Tanh", 3, 101),
    ("fa fa f", [32, 32, 1], "Tanh", 65, 100003),
    ("fa fa f", [32, 32, 3], "Tanh", 65, 401),
    ("fa fa fa fa f", [64, 64, 64, 64, 1], "Tanh", 21, 5000),
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
    if n == "passes":
        per_sm = fused_mlp._blocks_per_sm(load_library(), plan,
                                          torch.device("cuda", 0))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        n = 3 * sms * per_sm * plan.tile + 77
    x = torch.randn(n, in_dim, device=dev)
    with torch.no_grad():
        packed = fused_taylor.pack_weights(net.params(), net.layer_names)
        out = fused_mlp.fused_mlp_forward(packed, x, plan)
        ref = fused_mlp.fused_mlp_forward_plain(packed, x, plan)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_solver_predict_launches_the_mlp_kernel_once():
    # Each Solver.predict on the card runs the network through one launch
    # of the fused MLP kernel, at 10 points and at 300,000.
    _require_cuda()
    import numpy as np
    from pydens_tpu_torch import D, Solver

    def eq(f, x, y):
        return D(D(f, x), x) + D(D(f, y), y)
    solver = Solver(eq, ndims=2, boundary_condition=1, layout="fa fa fa f",
                    activation="Tanh", units=[10, 12, 15, 1], device="cuda")
    for n in (10, 300000):
        pts = np.random.default_rng(0).uniform(size=(n, 2)).astype(
            np.float32)
        before = fused_mlp.fused_mlp_forward.launches
        u = solver.predict(pts)
        assert fused_mlp.fused_mlp_forward.launches == before + 1
        assert u.shape == (n, 1) and np.isfinite(u).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["periodic", "fourier", "modified",
                                  "laaf", "second_ic"])
def test_model_options_route_on_cuda(kind):
    # The model options on the card: a periodic or Fourier-feature predict
    # is one MLP launch at the embedded width; modified and adaptive
    # models take the plain network; the second-IC wave's loss, and the
    # periodic and Fourier-feature ones from the embedding's Taylor state,
    # launch both Taylor kernels and equal the nested-gradient loss (rtol
    # 2e-5, gradients rtol 2e-3 / atol 2e-5).
    _require_cuda()
    import numpy as np
    from pydens_tpu_torch import D, Solver
    from pydens_tpu_torch.utils.criteria import mse_loss

    def wave(f, x, t):
        return D(D(f, t), t) - D(D(f, x), x)
    kw = dict(ndims=2, initial_condition=lambda x: torch.sin(np.pi * x),
              layout="fa fa f", features=[32, 32, 1], activation="Tanh")
    kw.update({"periodic": dict(periodic={0: 2}, periodic_ic_decay=False),
               "fourier": dict(fourier_features=(32, 8.0)),
               "modified": dict(arch="modified", layout="fafaf",
                                features=[16, 16, 1]),
               "laaf": dict(adaptive_activation=10.0),
               "second_ic": dict(initial_condition_t=0.0,
                                 boundary_condition=0.0)}[kind])
    solver = Solver(wave, device="cuda", **kw)
    pts = np.random.default_rng(0).uniform(size=(1000, 2)).astype(np.float32)
    before = fused_mlp.fused_mlp_forward.launches
    u = solver.predict(pts)
    embedded = kind in ("periodic", "fourier")
    assert fused_mlp.fused_mlp_forward.launches - before == int(
        embedded or kind == "second_ic")
    with torch.no_grad():
        ref = solver.model.apply(solver.model.params,
                                 torch.as_tensor(pts, device="cuda"))
    np.testing.assert_allclose(u, ref.cpu().numpy(), rtol=2e-5, atol=2e-5)
    closure = solver.model.plan_closure(solver._plan_derivs)
    kernels = kind in ("periodic", "fourier", "second_ic")
    assert (solver.model._fused_taylor_plan(closure) is not None) == kernels
    x = torch.as_tensor(pts[:256], device="cuda")
    results = []
    for use_plan in (True, False):
        loss_fn = solver._build_loss_fn((("equation", 1.0),), mse_loss,
                                        use_plan=use_plan)
        theta = loss_fn.spec.flatten(solver.model.params).detach()
        theta.requires_grad_(True)
        fwd = fused_taylor.fused_taylor_forward.launches
        loss = loss_fn(theta, x)
        grad, = torch.autograd.grad(loss, theta)
        assert fused_taylor.fused_taylor_forward.launches - fwd == int(
            use_plan and kernels)
        results.append((loss.detach(), grad))
    (pl, pg), (fl, fg) = results
    torch.testing.assert_close(pl, fl, rtol=2e-5, atol=0)
    torch.testing.assert_close(pg, fg, rtol=2e-3, atol=2e-5)


def _member_case(layout, features, act, in_dim, closure, n_members):
    """``(plan, MLP plan, (K, P) packed weights)``: one seeded network a
    member, on the card."""
    dev = torch.device("cuda")
    packs = []
    for k in range(n_members):
        net = make_layout_network(layout, features, act, in_dim=in_dim,
                                  device=dev)
        net.reset_parameters(torch.Generator().manual_seed(5 + k))
        with torch.no_grad():
            packs.append(fused_taylor.pack_weights(net.params(),
                                                   net.layer_names))
    plan = fused_taylor.TaylorPlan(net.tokens, net.activations, closure,
                                   net.layer_shapes, in_dim)
    mlp = fused_mlp.MlpPlan(net.tokens, net.activations, net.layer_shapes,
                            in_dim)
    return plan, mlp, torch.stack(packs)


@pytest.mark.gpu
@pytest.mark.parametrize("n_members", [1, 3, 8])
@pytest.mark.parametrize("layout,features,act,in_dim,closure,n", [
    ("fafaf", [12, 10, 1], "Tanh", 1, [(0,)], 400),     # examples/08
    (*README_CHAIN, 1000),
    ("fa fa f", [32, 32, 2], "Sigmoid", 2, POISSON_CLOSURE, 257),
])
def test_member_axis_kernels_match_single_and_plain_on_cuda(
        layout, features, act, in_dim, closure, n, n_members):
    # K members' (K, P) weights on shared points, one launch each kernel:
    # every member's slice of the forward, the tangent and the MLP equals a
    # single-member launch on its weights bit for bit, and so does d packed
    # where the blocks a member are the single model's (else at the
    # gradients' tolerance: another order of the partial sums); the whole
    # against the plain versions (values rtol/atol 2e-5, gradients rtol
    # 2e-3 / atol 2e-5, d x the sum over members); the backward bitwise
    # repeatable; K = 1 launches the single model's grid.
    _require_cuda()
    plan, mlp, packed = _member_case(layout, features, act, in_dim, closure,
                                     n_members)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    same_grid = (plan.launch_shape(n, sm, 3, n_members)[0]
                 == plan.launch_shape(n, sm, 3)[0])
    if n_members == 1:
        assert same_grid
    gen = torch.Generator("cuda").manual_seed(1)
    x = torch.rand((n, in_dim), device="cuda", generator=gen)
    v = torch.randn(packed.shape, device="cuda", generator=gen)
    out = fused_taylor.fused_taylor_forward(packed, x, plan)
    g = torch.randn(out.shape, device="cuda", generator=gen)
    dp, dx = fused_taylor.fused_taylor_backward(packed, x, g, plan)
    dp2, dx2 = fused_taylor.fused_taylor_backward(packed, x, g, plan)
    sv, tv = fused_taylor.fused_taylor_jvp(packed, x, v, plan)
    with torch.no_grad():
        mo = fused_mlp.fused_mlp_forward(packed, x, mlp)
    torch.cuda.synchronize()
    assert torch.equal(dp, dp2) and torch.equal(dx, dx2)
    for k in range(n_members):
        one = packed[k].contiguous()
        assert torch.equal(out[k], fused_taylor.fused_taylor_forward(
            one, x, plan))
        d1 = fused_taylor.fused_taylor_backward(one, x, g[k].contiguous(),
                                                plan)[0]
        if same_grid:
            assert torch.equal(dp[k], d1)
        else:
            torch.testing.assert_close(dp[k], d1, rtol=2e-3, atol=2e-5)
        s1, t1 = fused_taylor.fused_taylor_jvp(one, x, v[k].contiguous(),
                                               plan)
        assert torch.equal(sv[k], s1) and torch.equal(tv[k], t1)
        with torch.no_grad():
            assert torch.equal(mo[k], fused_mlp.fused_mlp_forward(one, x,
                                                                  mlp))
    torch.testing.assert_close(
        out, fused_taylor.fused_taylor_forward_plain(packed, x, plan),
        rtol=2e-5, atol=2e-5)
    rdp, rdx = fused_taylor.fused_taylor_backward_plain(packed, x, g, plan)
    torch.testing.assert_close(dp, rdp, rtol=2e-3, atol=2e-5)
    torch.testing.assert_close(dx, rdx, rtol=2e-3, atol=2e-5)
    rsv, rtv = fused_taylor.fused_taylor_jvp_plain(packed, x, v, plan)
    torch.testing.assert_close(sv, rsv, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(tv, rtv, rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        torch.testing.assert_close(
            mo, fused_mlp.fused_mlp_forward_plain(packed, x, mlp),
            rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_ensemble_fit_launches_once_a_step_and_predicts_in_one_launch():
    # An ensemble (K = 3) fit on the card: each eager step and capture
    # launches the forward and backward once, whatever K, and predict,
    # predict_all and predict_std one MLP launch each; the member mean of
    # predict_all is predict.
    _require_cuda()
    import numpy as np
    from pydens_tpu_torch import D, Solver

    def ode(f, x):
        return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)
    s = Solver(ode, ndims=1, initial_condition=.5, activation="Tanh",
               layout="fafaf", features=[12, 10, 1], n_models=3, seed=0)
    counters = (fused_taylor.fused_taylor_forward,
                fused_taylor.fused_taylor_backward,
                fused_mlp.fused_mlp_forward)
    for c in counters:
        c.launches = 0
    s.fit(niters=40, batch_size=256, lr=0.02, progress=False)
    (step,) = s._step_cache.values()
    assert step.eager_steps + step.replays == 40
    assert counters[0].launches == counters[1].launches == 2   # eager, capture
    xs = np.linspace(0, 1, 50)
    mean, allp, std = s.predict(xs), s.predict_all(xs), s.predict_std(xs)
    assert counters[2].launches == 3
    assert allp.shape == (3, 50, 1)
    np.testing.assert_allclose(mean, allp.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(std, allp.std(0), rtol=1e-4, atol=1e-6)
