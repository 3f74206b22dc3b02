"""The fused kernels' plain PyTorch versions against the JAX package's
Pallas kernels, run in interpret mode as tests/test_pallas_taylor.py and
tests/test_pallas_mlp.py run them on the CPU.  The CUDA kernels themselves
are held to these plain versions in tests/test_torch_kernels_gpu.py."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydens_tpu as jpdt
from pydens_tpu.models.layout import make_layout_network as jmake_network
from pydens_tpu.ops.pallas_mlp import make_fused_mlp_forward
from pydens_tpu.ops.pallas_taylor import make_fused_taylor
import pydens_tpu_torch as tpdt
from pydens_tpu_torch import params_from_jax
from pydens_tpu_torch.models.layout import make_layout_network
from pydens_tpu_torch.ops import fused_mlp, fused_taylor
from pydens_tpu_torch.ops._build import MAX_SHARED_BYTES

POISSON_CLOSURE = [(0,), (1,), (0, 0), (1, 1)]


def _jax_taylor_pair(layout, features, activation, in_dim, closure, seed=0):
    """JAX network + interpret-mode fused taps and the port's plan and
    packed weights for the same parameters."""
    init, apply, names = jmake_network(layout, features, activation,
                                       in_dim=in_dim)
    jparams = init(jax.random.key(seed))
    jtaps = make_fused_taylor(apply.tokens, apply.activations, names,
                              in_dim=in_dim, closure=closure, interpret=True)
    net = make_layout_network(layout, features, activation, in_dim=in_dim)
    plan = fused_taylor.TaylorPlan(net.tokens, net.activations, closure,
                                   net.layer_shapes, in_dim)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    packed = fused_taylor.pack_weights(tparams, net.layer_names)
    return jparams, jtaps, names, plan, packed


def _jax_streams(jtaps, plan):
    def streams(params, x):
        V, taps = jtaps(params, x)
        cols = ([V] + [taps[(d,)] for d in plan.firsts]
                + [taps[tuple(p)] for p in plan.pairs])
        return jnp.concatenate(cols, axis=1)
    return streams


@pytest.mark.parametrize("activation,closure", [
    ("Tanh", POISSON_CLOSURE),
    ("Sigmoid", [(0,), (1,), (0, 1)]),   # a mixed pair
    ("Sin", [(0,), (0, 0)]),
])
def test_taylor_plain_matches_pallas_interpret(activation, closure):
    # Values rtol/atol 2e-5; VJP rtol 2e-3 / atol 2e-5 — the tolerances of
    # tests/test_pallas_taylor.py (f32, different summation order).
    jparams, jtaps, names, plan, packed = _jax_taylor_pair(
        "fa fa f", [16, 16, 1], activation, 2, closure)
    rng = np.random.default_rng(7)
    x = (rng.uniform(size=(96, 2)) * 0.8 + 0.1).astype(np.float32)
    g = rng.normal(size=(96, plan.n_streams)).astype(np.float32)
    streams = _jax_streams(jtaps, plan)
    ref, vjp = jax.vjp(streams, jparams, jnp.asarray(x))
    out = fused_taylor.fused_taylor_forward_plain(packed, torch.from_numpy(x),
                                                  plan)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    jg_params, jg_x = vjp(jnp.asarray(g))
    d_packed, dx = fused_taylor.fused_taylor_backward_plain(
        packed, torch.from_numpy(x), torch.from_numpy(g), plan)
    ref_packed = fused_taylor.pack_weights(
        params_from_jax(jax.tree.map(np.asarray, jg_params)), names)
    np.testing.assert_allclose(d_packed.numpy(), ref_packed.numpy(),
                               rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jg_x), rtol=2e-3,
                               atol=2e-5)


def test_poisson_loss_and_grads_through_kernels_match_pallas(monkeypatch):
    # The tests/test_pallas_taylor.py setup end to end: Poisson 'fa fa f'
    # [16, 16, 1], 96 points; the JAX loss through the interpret-mode Pallas
    # kernel, the port's through FusedTaylor (plain version on the CPU).
    # Loss rtol 2e-5, grads rtol 2e-3 / atol 2e-5.
    monkeypatch.setenv("PYDENS_TPU_FUSED_TAYLOR", "always")

    def jpde(f, x, y):
        return (jpdt.D(jpdt.D(f, x), x) + jpdt.D(jpdt.D(f, y), y)
                - 5 * jpdt.sin(np.pi * (x + y)))

    def tpde(f, x, y):
        return (tpdt.D(tpdt.D(f, x), x) + tpdt.D(tpdt.D(f, y), y)
                - 5 * tpdt.sin(np.pi * (x + y)))

    kw = dict(ndims=2, boundary_condition=1, layout="fa fa f",
              activation="Tanh", units=[16, 16, 1], seed=0)
    js = jpdt.Solver(jpde, **kw)
    ts = tpdt.Solver(tpde, device="cpu", **kw)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    pts = (np.random.default_rng(7).uniform(size=(96, 2)) * 0.8
           + 0.1).astype(np.float32)
    crit = lambda a, b: jnp.mean((a - b) ** 2)
    jloss_fn, *_ = js._build_loss_fn((("equation", 1.0),), crit,
                                     use_plan=True)
    jl, jg = jax.value_and_grad(jloss_fn)(
        js.model.params, [jnp.asarray(pts[:, i:i + 1]) for i in range(2)])
    assert ts.model._fused_taylor_plan(POISSON_CLOSURE) is not None
    tloss_fn = ts._build_loss_fn((("equation", 1.0),),
                                 tpdt.solver.resolve_criterion("mse")[0],
                                 use_plan=True)
    theta = tloss_fn.spec.flatten(ts.model.params).detach().requires_grad_()
    launches = fused_taylor.fused_taylor_backward.launches
    tl = tloss_fn(theta, torch.from_numpy(pts))
    tg, = torch.autograd.grad(tl, theta)
    assert fused_taylor.fused_taylor_backward.launches == launches  # CPU
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    ref = tloss_fn.spec.flatten(params_from_jax(jax.tree.map(np.asarray, jg)))
    np.testing.assert_allclose(tg.numpy(), ref.numpy(), rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("activation,closure", [
    ("Tanh", POISSON_CLOSURE),
    ("Sigmoid", [(0,), (1,), (0, 1)]),
    ("Sin", [(0,), (0, 0)]),
])
def test_taylor_jvp_plain_matches_jax_jvp_of_the_plan(activation, closure):
    # The tangent of the traversal with respect to the weights:
    # fused_taylor_jvp_plain against jax.jvp of the JAX package's XLA plan
    # traversal (taylor_taps, which the JAX LM step linearizes), for a
    # seeded tangent of every weight.  Streams and tangent rtol/atol 2e-5.
    init, apply, names = jmake_network("fa fa f", [16, 16, 1], activation,
                                       in_dim=2)
    jparams = init(jax.random.key(0))
    net = make_layout_network("fa fa f", [16, 16, 1], activation, in_dim=2)
    plan = fused_taylor.TaylorPlan(net.tokens, net.activations, closure,
                                   net.layer_shapes, 2)
    rng = np.random.default_rng(8)
    tangent = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), jparams)
    x = (rng.uniform(size=(96, 2)) * 0.8 + 0.1).astype(np.float32)

    def streams(params):
        V, taps = apply.taylor_taps(params, jnp.asarray(x), closure)
        return jnp.concatenate([V] + [taps[(d,)] for d in plan.firsts]
                               + [taps[tuple(p)] for p in plan.pairs], axis=1)

    ref, tref = jax.jvp(streams, (jparams,),
                        (jax.tree.map(jnp.asarray, tangent),))
    packed = fused_taylor.pack_weights(
        params_from_jax(jax.tree.map(np.asarray, jparams)), names)
    v = fused_taylor.pack_weights(params_from_jax(tangent), names)
    out, tout = fused_taylor.fused_taylor_jvp_plain(
        packed, torch.from_numpy(x), v, plan)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(tref), rtol=2e-5,
                               atol=2e-5)


def test_fused_taylor_double_backward_is_jv_and_refuses_the_rest():
    # In float64: the VJP of FusedTaylor's backward with respect to its
    # cotangent is J v (central differences of the forward, rtol 1e-6);
    # a second derivative with respect to the weights raises, by
    # autograd.grad and by backward(), rather than returning zeros.
    net = make_layout_network("fa fa f", [5, 4, 1], "Tanh", in_dim=2,
                              dtype=torch.float64)
    net.reset_parameters(torch.Generator().manual_seed(0))
    plan = fused_taylor.TaylorPlan(net.tokens, net.activations,
                                   POISSON_CLOSURE, net.layer_shapes, 2)
    packed = fused_taylor.pack_weights(net.params(), net.layer_names)
    packed = packed.detach().requires_grad_()
    x = torch.rand(7, 2, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(1))
    out = fused_taylor.FusedTaylor.apply(packed, x, plan, True)
    u = torch.randn(out.shape, dtype=torch.float64).requires_grad_()
    jtu, = torch.autograd.grad(out, packed, u, create_graph=True)
    v = torch.randn(packed.shape, dtype=torch.float64)
    jv, = torch.autograd.grad(jtu, u, v, retain_graph=True)
    eps = 1e-6
    with torch.no_grad():
        fd = (fused_taylor.fused_taylor_forward_plain(packed + eps * v, x,
                                                      plan)
              - fused_taylor.fused_taylor_forward_plain(packed - eps * v, x,
                                                        plan)) / (2 * eps)
    torch.testing.assert_close(jv, fd, rtol=1e-6, atol=1e-8)
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.autograd.grad(jtu, packed, v, retain_graph=True)
    with pytest.raises(NotImplementedError, match="second derivative"):
        jtu.backward(v)


@pytest.mark.parametrize("layout,features", [
    ("fa fa f", [32, 32, 1]),
    ("fa fa fa f", [10, 12, 15, 1]),
    ("faR fa fa+ f", [16, 16, 16, 1]),
])
def test_mlp_plain_matches_pallas_interpret(layout, features):
    # tests/test_pallas_mlp.py: 2000 rows (not a tile multiple), rtol/atol
    # 2e-5.
    init, apply, names = jmake_network(layout, features, "Tanh", in_dim=3)
    jparams = init(jax.random.key(0))
    jfused = make_fused_mlp_forward(layout, apply.activations, names,
                                    interpret=True)
    net = make_layout_network(layout, features, "Tanh", in_dim=3)
    plan = fused_mlp.MlpPlan(net.tokens, net.activations, net.layer_shapes, 3)
    packed = fused_taylor.pack_weights(
        params_from_jax(jax.tree.map(np.asarray, jparams)), names)
    x = np.random.default_rng(1).normal(size=(2000, 3)).astype(np.float32)
    ref = np.asarray(jfused(jparams, jnp.asarray(x)))
    out = fused_mlp.fused_mlp_forward(packed, torch.from_numpy(x), plan)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind,act", [(fused_taylor.TANH, torch.tanh),
                                      (fused_taylor.SIGMOID, torch.sigmoid),
                                      (fused_taylor.SIN, torch.sin)])
def test_sigma_table_matches_nested_jvp(kind, act):
    # The Python mirror of the device code's closed-form s, s', s'', s'''
    # against nested torch.func.jvp-with-ones; f64, rtol/atol 1e-12.
    v = torch.linspace(-5.0, 5.0, 101, dtype=torch.float64)
    table = fused_taylor.sigma_table(kind, v)
    fk = act
    for k in range(4):
        torch.testing.assert_close(table[k], fk(v), rtol=1e-12, atol=1e-12)
        fk = (lambda f: lambda z: torch.func.jvp(
            f, (z,), (torch.ones_like(z),))[1])(fk)


def test_fused_taylor_autograd_function_gradcheck():
    # FusedTaylor's backward (the plain VJP on the CPU) against finite
    # differences, in float64.
    net = make_layout_network("fa fa f", [5, 4, 1], "Sigmoid", in_dim=2,
                              dtype=torch.float64)
    net.reset_parameters(torch.Generator().manual_seed(0))
    plan = fused_taylor.TaylorPlan(net.tokens, net.activations,
                                   [(0,), (1,), (0, 1), (1, 1)],
                                   net.layer_shapes, 2)
    packed = fused_taylor.pack_weights(net.params(), net.layer_names)
    packed = packed.detach().requires_grad_()
    x = torch.rand(7, 2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda p, z: fused_taylor.FusedTaylor.apply(p, z, plan, True),
        (packed, x))


def test_scope_guards():
    tanh, relu = torch.tanh, torch.relu
    shapes = [(2, 8), (8, 1)]
    assert fused_taylor.supports(["f", "a", "f"], [tanh], [(0,), (0, 0)],
                                 shapes, 2)
    assert not fused_taylor.supports(["f", "a", "R", "f", "+"], [tanh],
                                     [(0,)], shapes, 2)       # skips
    assert not fused_taylor.supports(["f", "a", "f"], [tanh],
                                     [(0,), (0, 0), (0, 0, 0)], shapes, 2)
    assert not fused_taylor.supports(["f", "a", "f"], [relu], [(0,)],
                                     shapes, 2)               # no closed form
    assert not fused_taylor.supports(["f", "a", "f"], [tanh], [(0,)],
                                     shapes, 2, dtype=torch.float64)
    assert not fused_taylor.supports(["f", "a", "f"], [tanh], [(0,)],
                                     [(2, 1024), (1024, 1)], 2)  # too wide
    # 128 wide: the forward and backward fit a block, and so does the
    # tangent kernel's (16 points a tile, the weights streamed, one block
    # an SM).
    wide = [(2, 128), (128, 128), (128, 1)]
    tokens = ["f", "a", "f", "a", "f"]
    assert fused_taylor.supports(tokens, [tanh, tanh], POISSON_CLOSURE,
                                 wide, 2)
    plan = fused_taylor.TaylorPlan(tokens, [tanh, tanh], POISSON_CLOSURE,
                                   wide, 2)
    assert plan.jvp_tile == 16 and plan.jvp_blocks_per_sm == 1
    assert not plan.jvp_resident
    assert plan.jvp_smem == 196_704 <= MAX_SHARED_BYTES
    assert fused_mlp.supports(["f", "a", "R", "f", "+"], [tanh],
                              [(2, 8), (8, 8)], 2)
    assert not fused_mlp.supports(["f", "a", "f"], [relu], shapes, 2)


def test_wrappers_never_take_the_plain_path_off_the_cpu():
    # A tensor that is not on the CPU gets the kernel or an error — here a
    # 'meta' tensor, which is neither CPU nor CUDA, so an error.
    net = make_layout_network("fa f", [4, 1], "Tanh", in_dim=2)
    tplan = fused_taylor.TaylorPlan(net.tokens, net.activations, [(0,)],
                                    net.layer_shapes, 2)
    mplan = fused_mlp.MlpPlan(net.tokens, net.activations, net.layer_shapes,
                              2)
    x = torch.empty(5, 2, device="meta")
    packed = torch.empty(tplan.n_params, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_taylor.fused_taylor_forward(packed, x, tplan)
    with pytest.raises(ValueError, match="CUDA"):
        fused_taylor.fused_taylor_backward(
            packed, x, torch.empty(5, 2, device="meta"), tplan)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_mlp_forward(packed, x, mplan)
    with pytest.raises(ValueError, match="CUDA"):
        fused_taylor.fused_taylor_jvp(packed, x, packed, tplan)


def test_mlp_forward_refuses_grad():
    net = make_layout_network("fa f", [4, 1], "Tanh", in_dim=2)
    plan = fused_mlp.MlpPlan(net.tokens, net.activations, net.layer_shapes, 2)
    packed = fused_taylor.pack_weights(net.params(), net.layer_names)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_mlp.fused_mlp_forward(packed, torch.zeros(3, 2), plan)


# The Taylor kernels' tile layout (csrc/fused_taylor.cu) as the wrapper
# mirrors it.  These run on the CPU: they read the CUDA source's constants
# and check the plan, the shared-memory reckoning and the backward's
# workspace that the wrapper computes for a launch.

HEAT_CLOSURE = [(0,), (1,), (2,), (0, 0), (1, 1)]   # 2D + t: 6 streams
CU_SOURCE = (Path(fused_taylor.__file__).resolve().parents[1] / "csrc"
             / "fused_taylor.cu")

# Every (chain, closure) the kernels are run on in
# tests/test_torch_kernels_gpu.py and chip_smoke.py.
KERNEL_CASES = [
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 2, POISSON_CLOSURE),
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 2, POISSON_CLOSURE),
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 3, HEAT_CLOSURE),
    ("fafaf", [12, 10, 1], "Tanh", 1, [(0,)]),
    ("fa fa f", [16, 16, 1], "Sigmoid", 3, [(0,), (2,), (0, 2)]),
    ("fa fa f", [16, 16, 1], "Sin", 2, [(0,), (1,), (0, 0), (0, 1)]),
]


def _cu_constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", CU_SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def _plan(layout, features, act, in_dim, closure):
    net = make_layout_network(layout, features, act, in_dim=in_dim)
    return fused_taylor.TaylorPlan(net.tokens, net.activations, closure,
                                   net.layer_shapes, in_dim)


@pytest.mark.parametrize("layout,features,act,in_dim,closure", [
    *KERNEL_CASES,
    ("fa f f a f", [9, 7, 5, 2], "Tanh", 2, [(0,), (1,), (0, 1)]),
    ("f a a f", [6, 3], "Sin", 2, [(0,), (0, 0)]),
])
def test_taylor_plan_table_matches_the_cuda_source(layout, features, act,
                                                   in_dim, closure):
    # The tile and table constants agree with the CUDA source, and the
    # backward's per-tile save layout keeps exactly the input state of each
    # activation and of each dense layer fed by a dense layer, packed
    # without gaps.
    assert fused_taylor._TILE_POINTS == _cu_constant("TILE_POINTS")
    assert fused_taylor._ROW_PAD == _cu_constant("ROW_PAD")
    assert fused_taylor._BLOCKS_PER_SM == _cu_constant("MIN_BLOCKS_PER_SM")
    for name in ("THREADS", "RING_SLOTS", "RING_ROWS"):
        assert getattr(fused_taylor, f"_{name}") == _cu_constant(name)
    plan = _plan(layout, features, act, in_dim, closure)
    header, op_ints = _cu_constant("HEADER_INTS"), _cu_constant("OP_INTS")
    tab = plan.table
    assert tab[:header] == [len(plan.ops), in_dim, len(plan.firsts),
                            len(plan.pairs), plan.wmax, plan.save_rows]
    records = tab[header + len(plan.firsts) + 2 * len(plan.pairs):]
    assert len(records) == op_ints * len(plan.ops)
    width, expect, prev = in_dim, 0, None
    for i, op in enumerate(plan.ops):
        rec = records[op_ints * i:op_ints * (i + 1)]
        keep = op[0] == "act" or prev == "dense"
        assert rec[-1] == plan.save_offsets[i] == (expect if keep else -1)
        if op[0] == "dense":
            assert rec[:5] == [0, op[1], op[2], op[3], op[4]]
            assert op[1] == width
        else:
            assert rec[:3] == [1, width, op[1]]
        if keep:
            expect += plan.n_streams * width
        width = op[2] if op[0] == "dense" else width
        prev = op[0]
    assert plan.save_rows == expect


@pytest.mark.parametrize("layout,features,act,in_dim,closure", KERNEL_CASES)
def test_supports_keeps_the_kernels_scope(layout, features, act, in_dim,
                                          closure):
    # Every configuration the kernels were built and checked for stays in
    # scope, and its backward (the larger block) fits shared memory; the
    # tangent kernel's block (the LM path) fits at 16 points a tile, two
    # blocks an SM (four tile states and the ring of weight slices: at the
    # 64-wide chain 98,400 B with 5 streams, 114,784 B with 6; narrower
    # chains keep the weights resident instead).
    net = make_layout_network(layout, features, act, in_dim=in_dim)
    assert fused_taylor.supports(net.tokens, net.activations, closure,
                                 net.layer_shapes, in_dim)
    plan = _plan(layout, features, act, in_dim, closure)
    assert plan.smem_bytes(2) < plan.smem_bytes(3) <= MAX_SHARED_BYTES
    assert plan.jvp_tile == 16 and plan.jvp_blocks_per_sm == 2
    assert plan.jvp_smem <= MAX_SHARED_BYTES
    if features[0] == 64:
        assert not plan.jvp_resident
        assert plan.jvp_smem == {5: 98_400, 6: 114_784}[plan.n_streams]
    else:
        assert plan.jvp_resident


def _sweep_closure(in_dim, n_streams):
    """``n_streams - 1`` multi-indices of order <= 2 over ``in_dim``
    inputs (the first-order ones first), or None where there are fewer."""
    firsts = [(d,) for d in range(in_dim)]
    pairs = [(a, b) for a in range(in_dim) for b in range(a, in_dim)]
    closure = (firsts + pairs)[:n_streams - 1]
    return closure if len(closure) == n_streams - 1 else None


@pytest.mark.parametrize("n_streams", range(2, 7))
def test_tangent_kernel_fits_wherever_supports_holds(n_streams):
    # Widths 4-160, 1-3 hidden layers, in_dim 1-4: supports() decides as
    # the forward's and backward's blocks always did (the packed weights
    # and three 16-point tile states within a block's shared memory), and
    # wherever it holds the tangent kernel's block fits at the plan's
    # points a tile: 16 at every chain up to 64 wide (two blocks an SM),
    # 8 or 4 only where the states at 16 do not fit.  The weights stay
    # resident where they and their tangent take at most 32 KB and the
    # block holds as many blocks an SM and points a tile as streamed.
    tanh = torch.tanh
    tiles = set()
    for in_dim in range(1, 5):
        closure = _sweep_closure(in_dim, n_streams)
        if closure is None:
            continue
        for hidden in range(1, 4):
            for width in range(4, 161):
                shapes = ([(in_dim, width)] + [(width, width)] * (hidden - 1)
                          + [(width, 1)])
                tokens = ["f", "a"] * hidden + ["f"]
                acts = [tanh] * hidden
                wmax = max(in_dim, width)
                n_params = sum(k * n + n for k, n in shapes)
                ld = 16 * n_streams + 4
                fwd = 4 * (-(-n_params // 4) * 4 + 2 * wmax * ld)
                bwd = 4 * (-(-n_params // 4) * 4 + 3 * wmax * ld)
                ok = fused_taylor.supports(tokens, acts, closure, shapes,
                                           in_dim)
                assert ok == (bwd <= MAX_SHARED_BYTES), (in_dim, hidden,
                                                        width)
                if not ok:
                    continue
                plan = fused_taylor.TaylorPlan(tokens, acts, closure, shapes,
                                               in_dim)
                assert (plan.smem_bytes(2), plan.smem_bytes(3)) == (fwd, bwd)
                assert plan.jvp_smem <= MAX_SHARED_BYTES
                tiles.add(plan.jvp_tile)
                weights = 2 * (-(-n_params // 4) * 4)
                streamed = fused_taylor._jvp_smem_bytes(
                    n_streams, wmax, plan.jvp_tile, n_params, False)
                if plan.jvp_resident:
                    assert weights <= 8192
                elif weights <= 8192:
                    # Resident, the block would hold fewer blocks an SM
                    # or fewer points a tile.
                    resident = fused_taylor._jvp_smem_bytes(
                        n_streams, wmax, plan.jvp_tile, n_params, True)
                    assert (resident > MAX_SHARED_BYTES
                            or fused_taylor._blocks_per_sm(resident)
                            < fused_taylor._blocks_per_sm(streamed))
                if plan.jvp_tile < 16:
                    # The states at 16 points, with the ring or the
                    # resident weights, do not fit.
                    assert fused_taylor._jvp_smem_bytes(
                        n_streams, wmax, 16, n_params,
                        plan.jvp_resident) > MAX_SHARED_BYTES
                if width <= 64:
                    assert plan.jvp_tile == 16
                    assert plan.jvp_blocks_per_sm == 2
    assert 16 in tiles


@pytest.mark.parametrize("n_streams", range(2, 9))
def test_smem_reckoning_admits_all_the_one_thread_per_point_design_did(
        n_streams):
    # The first design (one thread per point, 32 points per block, two
    # state buffers) needed 4 * (P + 2 * S * wmax * 32) bytes; the tiled
    # backward's three 16-point buffers need no more, so supports() admits
    # every (chain, closure) it admitted then.
    for wmax in (1, 2, 3, 5, 10, 15, 16, 63, 64, 100, 128, 200):
        for n_params in (3, 373, 8577, 20_601, 57_000):
            old = 4 * (n_params + 2 * n_streams * wmax * 32)
            new = fused_taylor._taylor_smem_bytes(n_params, n_streams, wmax,
                                                  3)
            assert new <= old, (n_params, wmax)


@pytest.mark.parametrize("layout,features,act,in_dim,closure",
                         KERNEL_CASES[:3])
@pytest.mark.parametrize("sm_count", [132, 114])   # H100 SXM, H100 PCIe
def test_backward_workspace_does_not_grow_with_n(layout, features, act,
                                                 in_dim, closure, sm_count):
    # The wrapper sizes the backward's save slabs and partial gradients by
    # the persistent grid's slots, never by n; the grid is the tile count
    # up to those slots.
    plan = _plan(layout, features, act, in_dim, closure)
    M = fused_taylor._TILE_POINTS
    small = plan.backward_workspace(1000, sm_count)
    large = plan.backward_workspace(1_000_000, sm_count)
    assert small[1:] == large[1:]
    _, slots = plan.launch_shape(1, sm_count, 3)
    assert small[0] == -(-1000 // M) <= slots and large[0] == slots
    assert large[1:] == (slots * plan.save_rows * M, slots * plan.n_params)
    if features[0] == 64 and len(closure) == 4:
        # The 64-wide Poisson chain: under 32 MiB at any n.
        assert 4 * sum(large[1:]) < 32 * 2**20


@pytest.mark.parametrize("layout,features,act,in_dim,closure,n,members,rows", [
    # 3 activations x 64 features x 5 streams; 4,096 tiles: 251,658,240 B
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 2, POISSON_CLOSURE, 65536, 1,
     3 * 64 * 5),
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 3, HEAT_CLOSURE, 65537, 4,
     3 * 64 * 6),
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 2, POISSON_CLOSURE, 100, 1,
     (10 + 12 + 15) * 5),
    # the activation (9 wide) and the dense layer fed by a dense layer (7)
    # and the second activation (5), 4 streams
    ("fa f f a f", [9, 7, 5, 2], "Tanh", 2, [(0,), (1,), (0, 1)], 50, 3,
     (9 + 7 + 5) * 4),
])
def test_state_floats_match_a_hand_count(layout, features, act, in_dim,
                                         closure, n, members, rows):
    # The states a forward keeps for its backward: (members, tiles,
    # save_rows, TILE_POINTS) floats, the last tile whole; the plain
    # forward on the CPU keeps none.
    plan = _plan(layout, features, act, in_dim, closure)
    M = fused_taylor._TILE_POINTS
    tiles = -(-n // M)
    assert plan.save_rows == rows
    assert plan.states_shape(n, members) == (members, tiles, rows, M)
    assert plan.state_floats(n, members) == members * tiles * rows * M
    if features[0] == 64 and members == 1:
        assert 4 * plan.state_floats(n) == 251_658_240
    packed = torch.zeros(plan.n_params)
    x = torch.rand(n, in_dim)
    out, states = fused_taylor.fused_taylor_forward(packed, x, plan,
                                                    keep_states=True)
    assert states is None and torch.equal(
        out, fused_taylor.fused_taylor_forward(packed, x, plan))


@pytest.mark.parametrize("n,members", [(65536, 1), (5_536_464, 1),
                                       (20000, 4), (100, 1)])
def test_states_are_kept_up_to_a_quarter_of_the_card(n, members):
    # A recorded forward keeps its states where their bytes (3,840 a point
    # and member at the 64-wide chain) are at most a quarter of the card's
    # memory: at exactly a quarter it keeps them, one byte less of card
    # and it recomputes them; an 80 GB card keeps 65,536 points.
    plan = _plan("fa fa fa f", [64, 64, 64, 1], "Tanh", 2, POISSON_CLOSURE)
    M = fused_taylor._TILE_POINTS
    nbytes = members * -(-n // M) * M * 3840
    assert 4 * plan.state_floats(n, members) == nbytes
    assert plan.keeps_states(n, members, 4 * nbytes)
    assert not plan.keeps_states(n, members, 4 * nbytes - 1)
    assert plan.keeps_states(n, members, 80 * 10**9) == (nbytes <= 20 * 10**9)
