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
        lambda p, z: fused_taylor.FusedTaylor.apply(p, z, plan), (packed, x))


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
    # scope, and its backward (the larger block) fits shared memory.
    net = make_layout_network(layout, features, act, in_dim=in_dim)
    assert fused_taylor.supports(net.tokens, net.activations, closure,
                                 net.layer_shapes, in_dim)
    plan = _plan(layout, features, act, in_dim, closure)
    assert plan.smem_bytes(2) < plan.smem_bytes(3) <= MAX_SHARED_BYTES


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
