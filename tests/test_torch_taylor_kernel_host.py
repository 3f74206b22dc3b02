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
    ("extern __shared__ float4 smem4[];", "float4* smem4 = host_smem;", 2),
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
    lib.host_taylor_forward.argtypes = [P, P, P, P] + [I] * 6
    lib.host_taylor_backward.argtypes = [P] * 8 + [I] * 6
    lib.host_taylor_smem_bytes.argtypes = [I] * 4
    lib.host_taylor_forward.restype = None
    lib.host_taylor_backward.restype = None
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("layout,features,act,in_dim,closure,n,sm_count", [
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
])
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
                                 P, S, W, plan.out_dim, grid)
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
        _ptr(dw), _ptr(dx), n, P, S, W, plan.out_dim, grid)
    rdp, rdx = fused_taylor.fused_taylor_backward_plain(
        packed, torch.from_numpy(x), torch.from_numpy(g), plan)
    np.testing.assert_allclose(dw, rdp.numpy(), rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(dx, rdx.numpy(), rtol=2e-3, atol=2e-5)
