"""The CUDA source of the fused Taylor kernels (csrc/fused_taylor.cu), run
on the CPU through a host emulation (tests/cuda_host/emulation.h: one OS
thread per CUDA thread, a barrier for __syncthreads) and held to the plain
PyTorch versions.  This checks the kernels' tiling, save layout, barriers
and fixed-order reduction at small shapes without a card; speed, and what
only the GPU's compiler can say, come from tests/test_torch_kernels_gpu.py
on the card.  Needs a C++20 compiler (g++)."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pydens_tpu_torch.models.layout import make_layout_network
from pydens_tpu_torch.ops import fused_taylor

HOST_DIR = Path(__file__).resolve().parent / "cuda_host"
CU_SOURCE = (Path(fused_taylor.__file__).resolve().parents[1] / "csrc"
             / "fused_taylor.cu")
POISSON_CLOSURE = [(0,), (1,), (0, 0), (1, 1)]

# (text or pattern, replacement, expected count): the CUDA-only lines of the
# source and what the host build puts in their place.
_HOST_EDITS = [
    ("#include <cuda_runtime.h>", '#include "emulation.h"', 1),
    # The tangent kernel's ring: cp.async held until its group is waited
    # for (emulation.h).
    ('asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" '
     '::"r"(smem_addr(dst)), "l"(src));', "host_cp_async(dst, src, 16);", 1),
    ('asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" '
     '::"r"(smem_addr(dst)), "l"(src));', "host_cp_async(dst, src, 4);", 1),
    ('void cp_async_commit() { asm volatile("cp.async.commit_group;\\n" '
     '::); }', "void cp_async_commit() { host_cp_commit(); }", 1),
    ('asm volatile("cp.async.wait_group %0;\\n" ::"n"(N));',
     "host_cp_wait(N);", 1),
    ("extern __shared__ float4 smem4[];", "float4* smem4 = host_smem;", 3),
    (re.compile(r"const unsigned base = [^;]*__cvta_generic_to_shared[^;]*;"),
     "", 1),
    (re.compile(r'asm volatile\("cp\.async\.ca\.shared\.global.*?\);',
                re.S),
     "dst[i] = src[i];", 1),
    (re.compile(r'asm volatile\("cp\.async\.(commit_group|wait_all);'
                r'\\n" ::\);'), "", 2),
]


def _host_source():
    src = CU_SOURCE.read_text()
    for old, new, count in _HOST_EDITS:
        if isinstance(old, str):
            found = src.count(old)
            src = src.replace(old, new)
        else:
            src, found = old.subn(new, src)
        assert found == count, f"host build: {old!r} found {found} times"
    # The host entries replace the CUDA launch code.
    src = src[:src.index("cudaError_t allow_smem")] + "}  // namespace\n"
    return src + (HOST_DIR / "taylor_entry.cpp").read_text()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host emulation of the kernels")
    out = tmp_path_factory.mktemp("taylor_host")
    (out / "taylor_host.cpp").write_text(_host_source())
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         f"-I{HOST_DIR}", "-o", str(out / "libtaylor_host.so"),
         str(out / "taylor_host.cpp")],
        capture_output=True, text=True, check=False)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out / "libtaylor_host.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.host_taylor_forward.argtypes = [P, P, P, P] + [I] * 7
    lib.host_taylor_backward.argtypes = [P] * 8 + [I] * 7
    lib.host_taylor_smem_bytes.argtypes = [I] * 4
    lib.host_taylor_jvp.argtypes = [P] * 6 + [I] * 9
    lib.host_taylor_jvp_smem_bytes.argtypes = [I] * 5
    lib.host_taylor_forward.restype = None
    lib.host_taylor_backward.restype = None
    lib.host_taylor_jvp.restype = None
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


HOST_CASES = [
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 2, POISSON_CLOSURE, 100, 132),
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 2, POISSON_CLOSURE, 1000, 3),
    ("fafaf", [12, 10, 1], "Tanh", 1, [(0,)], 400, 2),
    ("fa fa f", [16, 16, 1], "Sigmoid", 3, [(0,), (2,), (0, 2)], 257, 1),
    ("fa fa f", [16, 16, 1], "Sin", 2, [(0,), (1,), (0, 0), (0, 1)], 96, 2),
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 3,
     [(0,), (1,), (2,), (0, 0), (1, 1)], 33, 1),
    ("fa f f a f", [9, 7, 5, 2], "Tanh", 2, [(0,), (1,), (0, 1), (1, 1)],
     50, 1),                                    # a dense layer after a dense
    ("f a a f", [6, 3], "Sin", 2, [(0,), (0, 0)], 17, 4),   # act after act
    ("fa ff", [8, 4, 3], "Sigmoid", 2, [(0,), (1,), (0, 1)], 1, 1),
    ("fa fa", [5, 4], "Tanh", 2, [(0,), (1,), (1, 1)], 31, 2),  # ends in `a`
    # chip_smoke.py phase 10's chains: examples/09, examples/31 (three
    # hidden layers at order 2), examples/23's strong form
    ("fafaf", [32, 32, 1], "Tanh", 1, [(0,)], 130, 2),
    ("fa fa fa f", [48, 48, 48, 1], "Tanh", 1, [(0,), (0, 0)], 40, 1),
    ("fa fa f", [24, 24, 1], "Tanh", 1, [(0,), (0, 0)], 70, 2),
    # chip_smoke.py phase 11's system (examples/07: two outputs from one
    # input column, 2 streams) and the second-IC wave (5 streams)
    ("fa fa f", [32, 32, 2], "Tanh", 1, [(0,)], 90, 2),
    ("fa fa f", [32, 32, 1], "Tanh", 2, [(0,), (1,), (0, 0), (1, 1)], 45, 2),
    # chip_smoke.py phase 13's chains: examples/17's Laplacian in 3D (7
    # streams), its predict_grad plan (first-order streams only), and
    # first-order streams of a 3-output chain of 2 inputs
    ("fa fa f", [48, 48, 1], "Tanh", 3,
     [(0,), (1,), (2,), (0, 0), (1, 1), (2, 2)], 40, 1),
    ("fa fa f", [48, 48, 1], "Tanh", 3, [(0,), (1,), (2,)], 50, 2),
    ("fa fa f", [16, 16, 3], "Sigmoid", 2, [(0,), (1,)], 33, 1),
]


def _host_case(layout, features, act, in_dim, closure):
    net = make_layout_network(layout, features, act, in_dim=in_dim)
    net.reset_parameters(torch.Generator().manual_seed(0))
    plan = fused_taylor.TaylorPlan(net.tokens, net.activations, closure,
                                   net.layer_shapes, in_dim)
    packed = fused_taylor.pack_weights(net.params(), net.layer_names).detach()
    return plan, packed


@pytest.mark.parametrize("layout,features,act,in_dim,closure,n,sm_count",
                         HOST_CASES)
def test_taylor_kernels_on_the_host_match_plain(host_lib, layout, features,
                                                act, in_dim, closure, n,
                                                sm_count):
    # The grid the wrapper would launch on a card of `sm_count` SMs (a few
    # SMs: several tiles per persistent block).  Values rtol/atol 2e-5,
    # gradients rtol 2e-3 / atol 2e-5 (f32, other summation order); the
    # shared memory and the workspace start as NaN, so a read of anything
    # the kernel did not write fails the comparison.
    net = make_layout_network(layout, features, act, in_dim=in_dim)
    net.reset_parameters(torch.Generator().manual_seed(0))
    plan = fused_taylor.TaylorPlan(net.tokens, net.activations, closure,
                                   net.layer_shapes, in_dim)
    packed = fused_taylor.pack_weights(net.params(), net.layer_names).detach()
    S, W, P = plan.n_streams, plan.wmax, plan.n_params
    for n_bufs in (2, 3):
        assert host_lib.host_taylor_smem_bytes(P, S, W, n_bufs) == \
            plan.smem_bytes(n_bufs)
    assert host_lib.host_taylor_tile_points() == fused_taylor._TILE_POINTS
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(n, in_dim)).astype(np.float32)
    g = rng.normal(size=(n, S * plan.out_dim)).astype(np.float32)
    w = packed.numpy()
    tab = np.asarray(plan.table, np.int32)

    out = np.full((n, S * plan.out_dim), np.nan, np.float32)
    grid, _ = plan.launch_shape(n, sm_count, 2)
    host_lib.host_taylor_forward(_ptr(x), _ptr(w), _ptr(tab), _ptr(out), n,
                                 P, S, W, plan.out_dim, grid, 1)
    ref = fused_taylor.fused_taylor_forward_plain(packed, torch.from_numpy(x),
                                                  plan)
    np.testing.assert_allclose(out, ref.numpy(), rtol=2e-5, atol=2e-5)

    grid, save_floats, partial_floats = plan.backward_workspace(n, sm_count)
    saves = np.full(max(save_floats, 1), np.nan, np.float32)
    partials = np.full(partial_floats, np.nan, np.float32)
    dw = np.full(P, np.nan, np.float32)
    dx = np.full((n, in_dim), np.nan, np.float32)
    host_lib.host_taylor_backward(
        _ptr(x), _ptr(w), _ptr(tab), _ptr(g), _ptr(saves), _ptr(partials),
        _ptr(dw), _ptr(dx), n, P, S, W, plan.out_dim, grid, 1)
    rdp, rdx = fused_taylor.fused_taylor_backward_plain(
        packed, torch.from_numpy(x), torch.from_numpy(g), plan)
    np.testing.assert_allclose(dw, rdp.numpy(), rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(dx, rdx.numpy(), rtol=2e-3, atol=2e-5)


# The tangent kernel's own cases: (layout, features, act, in_dim, closure,
# n, sm_count, float offset of the weights and their tangent in their
# buffers).
JVP_CASES = [
    # several ring slices a layer: K = 64 (8 slices of 8 rows) and K = 20
    # (8, 8 and 4 rows)
    ("fa fa f", [64, 64, 1], "Tanh", 2, POISSON_CLOSURE, 40, 2, 0),
    ("fa fa f", [20, 20, 1], "Sigmoid", 2, POISSON_CLOSURE, 70, 2, 0),
    # odd widths, the weights at every 16-byte shift of their buffers
    ("fa fa f", [13, 7, 1], "Tanh", 2, [(0,), (1,), (0, 1)], 45, 3, 1),
    ("fa fa f", [13, 7, 1], "Sin", 2, [(0,), (1,), (0, 1)], 45, 3, 2),
    ("fa fa f", [13, 7, 1], "Tanh", 2, [(0,), (1,), (0, 1)], 45, 3, 3),
    # split K: the output layer N = 1 and N = 2
    ("fa fa f", [64, 48, 1], "Tanh", 2, [(0,), (1,)], 33, 2, 0),
    ("fa fa f", [32, 24, 2], "Sigmoid", 2, POISSON_CLOSURE, 33, 2, 1),
    # 6 streams (the heat closure), the 64-wide chain
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 3,
     [(0,), (1,), (2,), (0, 0), (1, 1)], 40, 2, 0),
    # 128 wide: two passes over the row groups a layer
    ("fa fa f", [128, 128, 1], "Tanh", 2, POISSON_CLOSURE, 20, 2, 0),
    # 8 points a tile (6 streams, 160 wide), and 8 with the weights
    # resident and 4 streamed (480 wide)
    ("fa f", [160, 1], "Tanh", 3, [(0,), (1,), (2,), (0, 0), (1, 1)], 30,
     2, 0),
    ("fa f", [480, 1], "Sin", 1, [(0,)], 13, 2, 1),
]


@pytest.mark.parametrize(
    "layout,features,act,in_dim,closure,n,sm_count,offset",
    [case + (0,) for case in HOST_CASES] + JVP_CASES)
def test_taylor_jvp_kernel_on_the_host_matches_plain(
        host_lib, layout, features, act, in_dim, closure, n, sm_count,
        offset):
    # The tangent kernel (taylor_jvp_kernel) on a seeded tangent of the
    # packed weights against fused_taylor_jvp_plain (torch.func.jvp of the
    # plain forward): streams and tangent rtol/atol 2e-5 (f32, other
    # summation order), from NaN-filled shared memory and outputs, at the
    # plan's points per tile and a grid of the blocks per SM that shared
    # memory allows; run twice, bitwise equal.  A JVP_CASES chain whose
    # plan keeps the weights resident runs streamed too, at the ring's tile.
    plan, packed = _host_case(layout, features, act, in_dim, closure)
    assert host_lib.host_taylor_jvp_smem_bytes(
        *plan.jvp_kernel_args()) == plan.jvp_smem <= \
        fused_taylor.MAX_SHARED_BYTES
    case = (layout, features, act, in_dim, closure, n, sm_count, offset)
    modes = _jvp_modes(plan) if case in JVP_CASES else _jvp_modes(plan)[:1]
    for resident, tile in modes:
        _check_host_jvp(host_lib, plan, packed, n, sm_count, offset,
                        resident, tile)


def _jvp_modes(plan):
    """``(resident, tile)`` of each way the host test runs the tangent
    kernel: the plan's, and streamed where the plan keeps the weights
    resident."""
    modes = [(plan.jvp_resident, plan.jvp_tile)]
    if plan.jvp_resident:
        modes.append((False, fused_taylor._jvp_tile(
            plan.n_streams, plan.wmax, plan.n_params, False)))
    return modes


def _check_host_jvp(host_lib, plan, packed, n, sm_count, offset, resident,
                    tile):
    S, W, P = plan.n_streams, plan.wmax, plan.n_params
    smem = fused_taylor._jvp_smem_bytes(S, W, tile, P, resident)
    assert host_lib.host_taylor_jvp_smem_bytes(S, W, tile, P,
                                               int(resident)) == smem
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(n, plan.in_dim)).astype(np.float32)
    v = rng.normal(size=P).astype(np.float32)
    # The weights and their tangent `offset` floats into their buffers.
    wbuf = np.full(P + offset, np.nan, np.float32)
    vbuf = np.full(P + offset, np.nan, np.float32)
    wbuf[offset:], vbuf[offset:] = packed.numpy(), v
    tab = np.asarray(plan.table, np.int32)
    grid = min(-(-n // tile), sm_count * fused_taylor._blocks_per_sm(smem))
    runs = []
    for _ in range(2):
        out = np.full((n, S * plan.out_dim), np.nan, np.float32)
        tout = np.full_like(out, np.nan)
        host_lib.host_taylor_jvp(_ptr(x), _ptr(wbuf[offset:]),
                                 _ptr(vbuf[offset:]), _ptr(tab), _ptr(out),
                                 _ptr(tout), n, P, S, W, plan.out_dim, tile,
                                 int(resident), grid, 1)
        runs.append((out, tout))
    ref, tref = fused_taylor.fused_taylor_jvp_plain(
        packed, torch.from_numpy(x), torch.from_numpy(v), plan)
    out, tout = runs[0]
    np.testing.assert_allclose(out, ref.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tout, tref.numpy(), rtol=2e-5, atol=2e-5)
    assert all(np.array_equal(a, b) for a, b in zip(runs[0], runs[1]))


def test_jvp_cases_take_the_designs_paths():
    # JVP_CASES reach what they are named for: 16, 8 and 4 points a tile,
    # the weights resident and streamed, more than one ring slice a layer,
    # split K, more than one pass.
    modes = {mode for case in JVP_CASES
             for mode in _jvp_modes(_host_case(*case[:5])[0])}
    assert {tile for _, tile in modes} == {16, 8, 4}
    assert {resident for resident, _ in modes} == {True, False}
    plan, _ = _host_case("fa fa f", [128, 128, 1], "Tanh", 2,
                         POISSON_CLOSURE)
    assert plan.jvp_tile == 16 and plan.jvp_blocks_per_sm == 1
    assert not plan.jvp_resident


def _host_members(host_lib, plan, packed, x, g, v, grid, jvp_grid):
    """Forward streams, ``(d packed, d x per member)`` and the tangent of
    ``K`` members' ``(K, P)`` weights in one member-axis launch each."""
    K, P = packed.shape
    S, W, n = plan.n_streams, plan.wmax, x.shape[0]
    cols = S * plan.out_dim
    tab = np.asarray(plan.table, np.int32)
    w = np.ascontiguousarray(packed)
    out = np.full((K, n, cols), np.nan, np.float32)
    host_lib.host_taylor_forward(_ptr(x), _ptr(w), _ptr(tab), _ptr(out), n,
                                 P, S, W, plan.out_dim, grid, K)
    saves = np.full(max(K * grid * plan.save_rows
                        * fused_taylor._TILE_POINTS, 1), np.nan, np.float32)
    partials = np.full(K * grid * P, np.nan, np.float32)
    dw = np.full((K, P), np.nan, np.float32)
    dx = np.full((K, n, plan.in_dim), np.nan, np.float32)
    host_lib.host_taylor_backward(
        _ptr(x), _ptr(w), _ptr(tab), _ptr(np.ascontiguousarray(g)),
        _ptr(saves), _ptr(partials), _ptr(dw), _ptr(dx), n, P, S, W,
        plan.out_dim, grid, K)
    sv = np.full((K, n, cols), np.nan, np.float32)
    tv = np.full((K, n, cols), np.nan, np.float32)
    host_lib.host_taylor_jvp(_ptr(x), _ptr(w), _ptr(np.ascontiguousarray(v)),
                             _ptr(tab), _ptr(sv), _ptr(tv), n, P, S, W,
                             plan.out_dim, plan.jvp_tile,
                             int(plan.jvp_resident), jvp_grid, K)
    return out, dw, dx, sv, tv


# (layout, features, act, in_dim, closure, n, sm_count) of the member
# axis: examples/08's chain (2 streams), a Sigmoid chain with a mixed
# second-order stream, the 64-wide chain with 6 streams (the tangent's
# weights streamed), a two-output chain with split K; a few tiles each.
MEMBER_CASES = [
    ("fafaf", [12, 10, 1], "Tanh", 1, [(0,)], 40, 2),
    ("fa fa f", [16, 16, 1], "Sigmoid", 3, [(0,), (2,), (0, 2)], 37, 1),
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 3,
     [(0,), (1,), (2,), (0, 0), (1, 1)], 33, 1),
    ("fa fa f", [32, 24, 2], "Sigmoid", 2, POISSON_CLOSURE, 33, 2),
]


@pytest.mark.parametrize("members", [1, 3])
@pytest.mark.parametrize("case", MEMBER_CASES)
def test_member_axis_kernels_on_the_host(host_lib, case, members):
    # The member axis (the grid's second axis): K members' weights (K, P),
    # shared points.  Each member's slice of the forward streams, d packed,
    # d x and the tangent equals a single-member launch on that member's
    # weights at the same blocks a member, bit for bit; the whole against
    # the plain versions (values rtol/atol 2e-5, gradients rtol 2e-3 /
    # atol 2e-5; d x the sum over members); from NaN-filled buffers.
    layout, features, act, in_dim, closure, n, sm_count = case
    plan, _ = _host_case(layout, features, act, in_dim, closure)
    nets = []
    for k in range(members):
        net = make_layout_network(layout, features, act, in_dim=in_dim)
        net.reset_parameters(torch.Generator().manual_seed(10 + k))
        nets.append(fused_taylor.pack_weights(net.params(),
                                              net.layer_names).detach())
    packed = torch.stack(nets)
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(n, in_dim)).astype(np.float32)
    cols = plan.n_streams * plan.out_dim
    g = rng.normal(size=(members, n, cols)).astype(np.float32)
    v = rng.normal(size=(members, plan.n_params)).astype(np.float32)
    grid, _ = plan.launch_shape(n, sm_count, 3, members)
    jgrid, _ = plan.jvp_launch_shape(n, sm_count, plan.jvp_blocks_per_sm,
                                     members)
    if members == 1:
        assert grid == plan.launch_shape(n, sm_count, 3)[0]
    whole = _host_members(host_lib, plan, packed.numpy(), x, g, v, grid,
                          jgrid)
    for k in range(members):
        one = _host_members(host_lib, plan, packed[k:k + 1].numpy(), x,
                            g[k:k + 1], v[k:k + 1], grid, jgrid)
        for a, b in zip(whole, one):
            assert np.array_equal(a[k:k + 1], b)
    out, dw, dx, sv, tv = whole
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        out, fused_taylor.fused_taylor_forward_plain(packed, xt, plan).numpy(),
        rtol=2e-5, atol=2e-5)
    rdp, rdx = fused_taylor.fused_taylor_backward_plain(
        packed, xt, torch.from_numpy(g), plan)
    np.testing.assert_allclose(dw, rdp.numpy(), rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(dx.sum(0), rdx.numpy(), rtol=2e-3, atol=2e-5)
    ref, tref = fused_taylor.fused_taylor_jvp_plain(packed, xt,
                                                    torch.from_numpy(v), plan)
    np.testing.assert_allclose(sv, ref.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tv, tref.numpy(), rtol=2e-5, atol=2e-5)
