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
    lib.host_taylor_forward.argtypes = [P] * 6 + [I] * 7
    lib.host_taylor_backward.argtypes = [P] * 9 + [I] * 8
    lib.host_taylor_smem_bytes.argtypes = [I] * 4
    lib.host_taylor_jvp.argtypes = [P] * 7 + [I] * 9
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
    host_lib.host_taylor_forward(_ptr(x), None, _ptr(w), _ptr(tab),
                                 _ptr(out), None, n, P, S, W, plan.out_dim,
                                 grid, 1)
    ref = fused_taylor.fused_taylor_forward_plain(packed, torch.from_numpy(x),
                                                  plan)
    np.testing.assert_allclose(out, ref.numpy(), rtol=2e-5, atol=2e-5)

    grid, save_floats, partial_floats = plan.backward_workspace(n, sm_count)
    saves = np.full(max(save_floats, 1), np.nan, np.float32)
    partials = np.full(partial_floats, np.nan, np.float32)
    dw = np.full(P, np.nan, np.float32)
    dx = np.full((n, in_dim), np.nan, np.float32)
    host_lib.host_taylor_backward(
        _ptr(x), None, _ptr(w), _ptr(tab), _ptr(g), _ptr(saves),
        _ptr(partials), _ptr(dw), _ptr(dx), n, P, S, W, plan.out_dim, grid,
        1, 0)
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
        host_lib.host_taylor_jvp(_ptr(x), None, _ptr(wbuf[offset:]),
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
    host_lib.host_taylor_forward(_ptr(x), None, _ptr(w), _ptr(tab),
                                 _ptr(out), None, n, P, S, W, plan.out_dim,
                                 grid, K)
    saves = np.full(max(K * grid * plan.save_rows
                        * fused_taylor._TILE_POINTS, 1), np.nan, np.float32)
    partials = np.full(K * grid * P, np.nan, np.float32)
    dw = np.full((K, P), np.nan, np.float32)
    dx = np.full((K, n, plan.in_dim), np.nan, np.float32)
    host_lib.host_taylor_backward(
        _ptr(x), None, _ptr(w), _ptr(tab), _ptr(np.ascontiguousarray(g)),
        _ptr(saves), _ptr(partials), _ptr(dw), _ptr(dx), n, P, S, W,
        plan.out_dim, grid, K, 0)
    sv = np.full((K, n, cols), np.nan, np.float32)
    tv = np.full((K, n, cols), np.nan, np.float32)
    host_lib.host_taylor_jvp(_ptr(x), None, _ptr(w),
                             _ptr(np.ascontiguousarray(v)),
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


def _plain_states(packed, x, plan):
    """The states a forward keeps for the backward, by the plain traversal:
    ``(tiles, save_rows, TILE_POINTS)``, row ``save_offsets[op] + j * S +
    s`` the stream ``s`` of feature ``j`` of the op's input state, the last
    tile's padded points as computed from x = 0."""
    M = fused_taylor._TILE_POINTS
    tiles = -(-x.shape[0] // M)
    V = torch.zeros(tiles * M, plan.in_dim)
    V[:x.shape[0]] = x
    eye = torch.eye(plan.in_dim)
    T = [eye[d].expand(len(V), plan.in_dim) for d in plan.firsts]
    S = [torch.zeros_like(V) for _ in plan.pairs]
    pos = {d: i for i, d in enumerate(plan.firsts)}
    states = torch.empty(tiles, plan.save_rows, M)
    for op, off in zip(plan.ops, plan.save_offsets):
        if off >= 0:
            st = torch.stack([V] + T + S)
            rows = st.shape[2] * plan.n_streams
            states[:, off:off + rows] = st.permute(2, 0, 1).reshape(
                rows, tiles, M).permute(1, 0, 2)
        if op[0] == "dense":
            _, K, N, w_off, b_off = op
            out = torch.stack([V] + T + S) @ packed[w_off:w_off + K * N].view(
                K, N)
            V = out[0] + packed[b_off:b_off + N]
            T, S = list(out[1:1 + len(T)]), list(out[1 + len(T):])
        else:
            d = fused_taylor.sigma_table(op[1], V)
            S = [d[2] * T[pos[a]] * T[pos[b]] + d[1] * s
                 for (a, b), s in zip(plan.pairs, S)]
            T = [d[1] * t for t in T]
            V = d[0]
    return states


def _host_paths(host_lib, plan, packed, x, g, grid):
    """``[out keeping no states, out keeping them]``, the states, and
    ``[(d packed, d x) recomputing, (d packed, d x) from the states twice]``
    of ``K`` members' ``(K, P)`` weights, from NaN-filled buffers."""
    K, P = packed.shape
    S, W, n = plan.n_streams, plan.wmax, x.shape[0]
    tiles = -(-n // fused_taylor._TILE_POINTS)
    tab = np.asarray(plan.table, np.int32)
    w = np.ascontiguousarray(packed)
    states = np.full(plan.states_shape(n, K), np.nan, np.float32)
    assert states.size == plan.state_floats(n, K)
    outs = []
    for keep in (None, states):
        out = np.full((K, n, S * plan.out_dim), np.nan, np.float32)
        host_lib.host_taylor_forward(
            _ptr(x), None, _ptr(w), _ptr(tab), _ptr(out),
            None if keep is None else _ptr(keep), n, P, S, W, plan.out_dim,
            grid, K)
        outs.append(out)
    grads = []
    for from_states in (0, 1, 1):
        saves = (states if from_states else
                 np.full(max(K * grid * plan.save_rows
                             * fused_taylor._TILE_POINTS, 1), np.nan,
                         np.float32))
        partials = np.full(K * grid * P, np.nan, np.float32)
        dw = np.full((K, P), np.nan, np.float32)
        dx = np.full((K, n, plan.in_dim), np.nan, np.float32)
        host_lib.host_taylor_backward(
            _ptr(x), None, _ptr(w), _ptr(tab), _ptr(np.ascontiguousarray(g)),
            _ptr(saves), _ptr(partials), _ptr(dw), _ptr(dx), n, P, S, W,
            plan.out_dim, grid, K, from_states)
        grads.append((dw, dx))
    assert states.shape == (K, tiles, plan.save_rows,
                            fused_taylor._TILE_POINTS)
    return outs, states, grads


@pytest.mark.parametrize(
    "layout,features,act,in_dim,closure,n,sm_count,members",
    [case + (1,) for case in HOST_CASES]
    + [case + (3,) for case in MEMBER_CASES])
def test_backward_from_states_on_the_host_is_the_recompute(
        host_lib, layout, features, act, in_dim, closure, n, sm_count,
        members):
    # A forward that keeps its states: its streams bit for bit those of a
    # forward that keeps none; every element of its (members, tiles,
    # save_rows, TILE_POINTS) states written (from NaN) and equal to the
    # plain traversal's input states of the ops the backward reads (values
    # rtol/atol 2e-5), the padded points included.  The backward from those
    # states gives d packed and d x bit for bit those of the backward that
    # recomputes them, twice.
    plan, _ = _host_case(layout, features, act, in_dim, closure)
    nets = []
    for k in range(members):
        net = make_layout_network(layout, features, act, in_dim=in_dim)
        net.reset_parameters(torch.Generator().manual_seed(k))
        nets.append(fused_taylor.pack_weights(net.params(),
                                              net.layer_names).detach())
    packed = torch.stack(nets)
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(n, in_dim)).astype(np.float32)
    g = rng.normal(size=(members, n, plan.n_streams * plan.out_dim)).astype(
        np.float32)
    grid, _ = plan.launch_shape(n, sm_count, 3, members)
    (out, kept), states, grads = _host_paths(host_lib, plan, packed.numpy(),
                                             x, g, grid)
    assert np.array_equal(out, kept)
    assert np.isfinite(states).all()
    for k in range(members):
        np.testing.assert_allclose(
            states[k], _plain_states(packed[k], torch.from_numpy(x),
                                     plan).numpy(), rtol=2e-5, atol=2e-5)
    (dw0, dx0), (dw1, dx1), (dw2, dx2) = grads
    assert np.array_equal(dw0, dw1) and np.array_equal(dx0, dx1)
    assert np.array_equal(dw1, dw2) and np.array_equal(dx1, dx2)


# Chains that start from an embedding's Taylor state (the kernels' input
# state): (name, ConvBlockModel options, closure, n, sm_count).  A periodic
# x with 1 and 2 harmonics under the Schrodinger closure (the (x, x) tap:
# its state's second-order taps -w^2 sin, -w^2 cos are not 0), a periodic x
# and y, and random Fourier features of a 1-D Poisson closure.
NLS_CLOSURE = [(0,), (1,), (0, 0)]
EMBEDDED_CASES = [
    ("periodic1", dict(ndims=2, periodic=(0,), units=[16, 16, 2],
                       domain=[(-5.0, 5.0), (0.0, 1.5707964)]),
     NLS_CLOSURE, 64, 2),
    ("periodic2", dict(ndims=2, periodic={0: 2}, units=[16, 16, 2],
                       domain=[(-5.0, 5.0), (0.0, 1.5707964)]),
     NLS_CLOSURE, 37, 1),
    ("periodic_xy", dict(ndims=3, periodic=(0, 1), units=[12, 12, 3]),
     [(0,), (1,), (2,), (0, 0), (1, 1)], 33, 2),
    ("fourier", dict(ndims=1, fourier_features=(4, 2.0), units=[16, 16, 1]),
     [(0,), (0, 0)], 50, 2),
]


def _embedded_case(kw, closure, n, seed=5):
    """A ConvBlockModel of ``kw`` (Tanh ``fa fa f``), its plan from the
    embedding's state, packed weights, points in its domain and the input
    state ``(n, n_streams, in_dim)`` that the model hands the kernels."""
    from pydens_tpu_torch.models.base import ConvBlockModel
    model = ConvBlockModel(layout="fa fa f", activation="Tanh", device="cpu",
                           **kw)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    plan = model._fused_taylor_plan(closure)
    assert plan is not None and plan.input_state
    packed = fused_taylor.pack_weights(model.network_params(),
                                       model.net.dense_names).detach()
    lo = torch.tensor([d[0] for d in model.domain])
    hi = torch.tensor([d[1] for d in model.domain])
    xs = lo + (hi - lo) * torch.rand(n, len(lo),
                                     generator=torch.Generator().manual_seed(7))
    V, taps = model._embed_state(xs, closure)
    state = torch.stack([V] + [taps[(d,)] for d in plan.firsts]
                        + [taps[tuple(ab)] for ab in plan.pairs], dim=1)
    return model, plan, packed, xs, state.contiguous()


def _host_from_state(host_lib, plan, packed, state, g, grid, input_grad=True):
    """Forward streams (keeping its states), and ``(d packed, d state)``
    recomputing and from the forward's states, from an input state, each
    from NaN-filled buffers."""
    S, W, P, n = plan.n_streams, plan.wmax, plan.n_params, state.shape[0]
    tab = np.asarray(plan.table, np.int32)
    w = np.ascontiguousarray(packed)
    xs = np.ascontiguousarray(state)
    out = np.full((n, S * plan.out_dim), np.nan, np.float32)
    states = np.full(plan.states_shape(n), np.nan, np.float32)
    host_lib.host_taylor_forward(None, _ptr(xs), _ptr(w), _ptr(tab),
                                 _ptr(out), _ptr(states), n, P, S, W,
                                 plan.out_dim, grid, 1)
    grads = []
    for from_states in (0, 1):
        saves = (states if from_states else
                 np.full(max(grid * plan.save_rows
                             * fused_taylor._TILE_POINTS, 1), np.nan,
                         np.float32))
        partials = np.full(grid * P, np.nan, np.float32)
        dw = np.full(P, np.nan, np.float32)
        dx = (np.full(plan.input_shape(n), np.nan, np.float32)
              if input_grad else None)
        host_lib.host_taylor_backward(
            None, _ptr(xs), _ptr(w), _ptr(tab), _ptr(np.ascontiguousarray(g)),
            _ptr(saves), _ptr(partials), _ptr(dw),
            None if dx is None else _ptr(dx), n, P, S, W, plan.out_dim, grid,
            1, from_states)
        grads.append((dw, dx))
    return out, grads


@pytest.mark.parametrize("name,kw,closure,n,sm_count", EMBEDDED_CASES)
def test_kernels_from_an_embedding_state_match_the_plain_traversal(
        host_lib, name, kw, closure, n, sm_count):
    # The forward from the embedding's input state against the model's
    # plain traversal from the same state (values rtol/atol 2e-5); the
    # backward's d packed and the state's cotangent against the plain
    # version's autograd VJP (rtol 2e-3 / atol 2e-5), recomputing and from
    # the forward's states bit for bit alike; the tangent kernel against
    # torch.func.jvp (2e-5).  All from NaN-filled buffers.
    model, plan, packed, xs, state = _embedded_case(kw, closure, n)
    grid, _ = plan.launch_shape(n, sm_count, 3)
    rng = np.random.default_rng(8)
    g = rng.normal(size=(n, plan.n_streams * plan.out_dim)).astype(np.float32)
    out, ((dw0, ds0), (dw1, ds1)) = _host_from_state(
        host_lib, plan, packed.numpy(), state.numpy(), g, grid)
    with torch.no_grad():
        V, taps = model.network_taylor_plain(model.network_params(), xs,
                                             closure)
    ref = torch.cat([V] + [taps[(d,)] for d in plan.firsts]
                    + [taps[tuple(ab)] for ab in plan.pairs], dim=1)
    np.testing.assert_allclose(out, ref.numpy(), rtol=2e-5, atol=2e-5)
    rdp, rds = fused_taylor.fused_taylor_backward_plain(
        packed, state, torch.from_numpy(g), plan)
    np.testing.assert_allclose(dw0, rdp.numpy(), rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(ds0, rds.numpy(), rtol=2e-3, atol=2e-5)
    assert np.array_equal(dw0, dw1) and np.array_equal(ds0, ds1)
    v = rng.normal(size=plan.n_params).astype(np.float32)
    sv = np.full_like(out, np.nan)
    tv = np.full_like(out, np.nan)
    host_lib.host_taylor_jvp(
        None, _ptr(state.numpy()), _ptr(packed.numpy()), _ptr(v),
        _ptr(np.asarray(plan.table, np.int32)), _ptr(sv), _ptr(tv), n,
        plan.n_params, plan.n_streams, plan.wmax, plan.out_dim, plan.jvp_tile,
        int(plan.jvp_resident),
        plan.jvp_launch_shape(n, sm_count, plan.jvp_blocks_per_sm)[0], 1)
    rsv, rtv = fused_taylor.fused_taylor_jvp_plain(packed, state,
                                                   torch.from_numpy(v), plan)
    np.testing.assert_allclose(sv, rsv.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tv, rtv.numpy(), rtol=2e-5, atol=2e-5)


def test_the_xx_tap_of_the_state_reaches_the_streams(host_lib):
    # The periodic state's (x, x) taps are -w^2 sin and -w^2 cos, not 0:
    # with them zeroed the streams' (x, x) block moves (it is what u_xx of
    # the Schrodinger residual reads), and the kernel's follows the plain
    # version in both.
    name, kw, closure, n, sm_count = EMBEDDED_CASES[0]
    _, plan, packed, _, state = _embedded_case(kw, closure, n)
    grid, _ = plan.launch_shape(n, sm_count, 3)
    g = np.zeros((n, plan.n_streams * plan.out_dim), np.float32)
    zeroed = state.clone()
    zeroed[:, 1 + len(plan.firsts):] = 0
    w = 2 * np.pi / 10
    np.testing.assert_allclose(torch.linalg.vector_norm(
        state[:, 1 + len(plan.firsts), :2], dim=1).numpy(), w * w, rtol=1e-5)
    outs = []
    for st in (state, zeroed):
        out, _ = _host_from_state(host_lib, plan, packed.numpy(), st.numpy(),
                                  g, grid, input_grad=False)
        np.testing.assert_allclose(
            out, fused_taylor.fused_taylor_forward_plain(packed, st,
                                                         plan).numpy(),
            rtol=2e-5, atol=2e-5)
        outs.append(out)
    k = plan.out_dim
    pair = slice((1 + len(plan.firsts)) * k, (2 + len(plan.firsts)) * k)
    assert np.abs(outs[0][:, pair] - outs[1][:, pair]).max() > 1e-2
    assert np.array_equal(outs[0][:, :pair.start], outs[1][:, :pair.start])


@pytest.mark.parametrize(
    "layout,features,act,in_dim,closure,n,sm_count",
    [HOST_CASES[i] for i in (0, 3, 5, 6, 14)])
def test_the_raw_seed_as_an_input_state_gives_the_same_bits(
        host_lib, layout, features, act, in_dim, closure, n, sm_count):
    # The raw path's start (V = x, T_d = e_d, S = 0) handed over as an input
    # state: the forward's streams and states, and the backward's d packed
    # (recomputing and from the states), bit for bit those of the raw path;
    # the state's V rows' cotangent bit for bit the raw path's d x.
    plan, packed = _host_case(layout, features, act, in_dim, closure)
    splan = fused_taylor.TaylorPlan(*_plan_args(layout, features, act,
                                                in_dim, closure),
                                    input_state=True)
    assert splan.table == plan.table
    rng = np.random.default_rng(9)
    x = rng.uniform(size=(n, in_dim)).astype(np.float32)
    g = rng.normal(size=(1, n, plan.n_streams * plan.out_dim)).astype(
        np.float32)
    eye = np.eye(in_dim, dtype=np.float32)
    seed = np.zeros((n, plan.n_streams, in_dim), np.float32)
    seed[:, 0] = x
    for i, d in enumerate(plan.firsts):
        seed[:, 1 + i] = eye[d]
    grid, _ = plan.launch_shape(n, sm_count, 3)
    (_, kept), states, grads = _host_paths(host_lib, plan,
                                           packed[None].numpy(), x, g, grid)
    out, sgrads = _host_from_state(host_lib, splan, packed.numpy(), seed,
                                   g[0], grid)
    assert np.array_equal(out, kept[0])
    for (dw, dx), (sdw, sdx) in zip(grads[:2], sgrads):
        assert np.array_equal(dw[0], sdw)
        assert np.array_equal(dx[0], sdx[:, 0])


def _plan_args(layout, features, act, in_dim, closure):
    net = make_layout_network(layout, features, act, in_dim=in_dim)
    return (net.tokens, net.activations, closure, net.layer_shapes, in_dim)
