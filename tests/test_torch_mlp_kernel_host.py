"""The CUDA source of the fused MLP kernel (csrc/fused_mlp.cu), run on the
CPU through a host emulation (tests/cuda_host/emulation.h: one OS thread
per CUDA thread, a barrier for __syncthreads, NaN-filled shared memory) and
held to the plain PyTorch version.  This checks the kernel's tiling, weight
staging, skip stack, persistent loop and masking at small shapes without a
card; its fast activations run exactly here (the special-function unit's
approximations are emulated by the exact functions), so their error, and
speed, come from
tests/test_torch_kernels_gpu.py on the card.  Needs a C++20 compiler (g++).

The CPU checks of the wrapper's shared-memory reckoning and scope are here
too."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pydens_tpu_torch.models.layout import make_layout_network
from pydens_tpu_torch.ops import fused_mlp
from pydens_tpu_torch.ops._build import MAX_SHARED_BYTES
from pydens_tpu_torch.ops.fused_taylor import pack_weights

HOST_DIR = Path(__file__).resolve().parent / "cuda_host"
CU_SOURCE = (Path(fused_mlp.__file__).resolve().parents[1] / "csrc"
             / "fused_mlp.cu")
VALUE_TOL = dict(rtol=2e-5, atol=2e-5)

# (text or pattern, replacement, expected count): the CUDA-only lines of the
# source and what the host build puts in their place.
_HOST_EDITS = [
    ("#include <cuda_runtime.h>", '#include "emulation.h"', 1),
    ("extern __shared__ float4 smem4[];", "float4* smem4 = host_smem;", 1),
    (re.compile(r'asm volatile\("cp\.async\.ca\.shared\.global.*?\);', re.S),
     "*dst = *src;", 1),
    (re.compile(r'asm volatile\("cp\.async\.cg\.shared\.global.*?\);', re.S),
     "std::copy(src, src + 4, dst);", 1),
    (re.compile(r'asm volatile\("cp\.async\.(commit_group|wait_all);'
                r'\\n" ::\);'), "", 2),
    # The special-function unit's approximations, computed exactly.
    ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));',
     "r = std::exp2(v);", 1),
    ('asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));',
     "r = 1.f / v;", 1),
]

# The layouts of tests/test_pallas_mlp.py (3 inputs, the skip layout
# included).
PALLAS_LAYOUTS = [("fa fa f", [32, 32, 1]),
                  ("fa fa fa f", [10, 12, 15, 1]),
                  ("faR fa fa+ f", [16, 16, 16, 1])]


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
    src = src[:src.index("// ---- launch code")]
    return src + (HOST_DIR / "mlp_entry.cpp").read_text()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host emulation of the kernel")
    out = tmp_path_factory.mktemp("mlp_host")
    (out / "mlp_host.cpp").write_text(_host_source())
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         f"-I{HOST_DIR}", "-o", str(out / "libmlp_host.so"),
         str(out / "mlp_host.cpp")],
        capture_output=True, text=True, check=False)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out / "libmlp_host.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.host_mlp_forward.argtypes = [P, P, P, P] + [I] * 8
    lib.host_mlp_forward.restype = None
    lib.host_mlp_smem_bytes.argtypes = [I] * 5
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _plan(layout, features, act, in_dim):
    net = make_layout_network(layout, features, act, in_dim=in_dim)
    net.reset_parameters(torch.Generator().manual_seed(0))
    plan = fused_mlp.MlpPlan(net.tokens, net.activations, net.layer_shapes,
                             in_dim)
    return plan, pack_weights(net.params(), net.layer_names).detach()


def _run(host_lib, plan, packed, x, grid):
    """The host kernel's output for points ``x`` on ``grid`` blocks; the
    output starts as NaN, so a point the kernel did not write fails."""
    out = np.full((x.shape[0], plan.out_dim), np.nan, np.float32)
    w = packed.numpy()
    tab = np.asarray(plan.table, np.int32)
    host_lib.host_mlp_forward(_ptr(x), _ptr(w), _ptr(tab), _ptr(out),
                              x.shape[0], *plan.kernel_args(), plan.out_dim,
                              grid)
    return out


def _points(n, in_dim, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, in_dim)).astype(np.float32)


def _check(host_lib, plan, packed, x, grid):
    out = _run(host_lib, plan, packed, x, grid)
    ref = fused_mlp.fused_mlp_forward_plain(packed, torch.from_numpy(x),
                                            plan)
    np.testing.assert_allclose(out, ref.numpy(), **VALUE_TOL)


@pytest.mark.parametrize("act", ["Tanh", "Sigmoid", "Sin"])
@pytest.mark.parametrize("layout,features", PALLAS_LAYOUTS)
def test_mlp_kernel_on_the_host_matches_plain(host_lib, layout, features,
                                              act):
    # 300 points on 2 blocks: 3 tiles of 128, so block 0 walks two of them
    # and the last is ragged.  rtol/atol 2e-5 against the plain version.
    plan, packed = _plan(layout, features, act, 3)
    assert plan.tile == 128
    x = _points(300, 3)
    assert plan.launch_shape(300, 2, 1) == 2
    _check(host_lib, plan, packed, x, 2)


@pytest.mark.parametrize("n,grid", [
    (1, 1),
    (127, 1),            # tile - 1
    (129, 1),            # tile + 1
    (2 * 2 * 128 + 5, 2),  # beyond grid x tile: the loop turns 3 times
])
def test_mlp_kernel_on_the_host_ragged_n(host_lib, n, grid):
    plan, packed = _plan("fa fa fa f", [10, 12, 15, 1], "Tanh", 2)
    assert plan.tile == 128
    _check(host_lib, plan, packed, _points(n, 2), grid)


def test_mlp_kernel_on_the_host_no_points(host_lib):
    # n = 0: the wrapper launches nothing (a grid of 0), and a block given
    # no tile writes nothing.
    plan, packed = _plan("fa fa fa f", [10, 12, 15, 1], "Tanh", 2)
    assert plan.launch_shape(0, 132, 8) == 0
    x = _points(0, 2)
    assert _run(host_lib, plan, packed, x, 1).shape == (0, 1)
    out = fused_mlp.fused_mlp_forward(packed, torch.from_numpy(x), plan)
    assert out.shape == (0, 1)


@pytest.mark.parametrize("layout,features,act,in_dim,n,tile", [
    # Layouts whose state needs a smaller tile to fit shared memory.
    ("fa fa fa f", [128, 128, 128, 1], "Tanh", 3, 150, 64),
    ("fa fa f", [180, 180, 1], "Sigmoid", 2, 70, 32),
    # Passes of their own: an activation after an activation, sin, a chain
    # that ends in an activation, a skip around two layers, two outputs.
    ("f a a f", [6, 3], "Sin", 2, 130, 128),
    ("fa fa", [5, 4], "Sigmoid", 2, 40, 128),
    ("fR fa f+ a f", [8, 8, 8, 2], "Tanh", 1, 200, 128),
    ("fa f f a f", [9, 7, 5, 2], "Tanh", 2, 50, 128),
    # Eight features a thread with the last two masked (30 padded to 32).
    ("fafaf", [30, 40, 1], "Sigmoid", 4, 150, 128),
    # chip_smoke.py phase 10's predicts: examples/09, /31, /23 and the beam.
    ("fafaf", [32, 32, 1], "Tanh", 1, 200, 128),
    ("fa fa fa f", [48, 48, 48, 1], "Tanh", 1, 201, 128),
    ("fa fa f", [24, 24, 1], "Tanh", 1, 101, 128),
])
def test_mlp_kernel_on_the_host_other_chains(host_lib, layout, features, act,
                                             in_dim, n, tile):
    plan, packed = _plan(layout, features, act, in_dim)
    assert plan.tile == tile
    _check(host_lib, plan, packed, _points(n, in_dim), 2)


def test_mlp_kernel_on_the_host_unaligned_points(host_lib):
    # Points that start 4 bytes past a 16-byte boundary take the 4-byte
    # copies.
    plan, packed = _plan("fa fa f", [32, 32, 1], "Tanh", 3)
    buf = np.zeros(200 * 3 + 4, np.float32)
    start = (4 - buf.ctypes.data % 16) % 16 // 4
    x = buf[start:start + 600].reshape(200, 3)
    x[...] = _points(200, 3)
    assert x.ctypes.data % 16 == 4
    _check(host_lib, plan, packed, x, 1)


# Every chain the kernel runs on in chip_smoke.py and
# tests/test_torch_kernels_gpu.py: (layout, features, act, in_dim).
KERNEL_CHAINS = [
    ("fa fa f", [32, 32, 1], "Tanh", 3),
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 3),
    ("faR fa fa+ f", [16, 16, 16, 1], "Tanh", 3),
    ("fa fa fa f", [64, 64, 64, 1], "Tanh", 3),
    ("fa fa fa f", [10, 12, 15, 1], "Tanh", 2),     # README predict
    ("fafaf", [12, 10, 1], "Tanh", 1),              # w2
    ("fafaf", [30, 40, 1], "Sigmoid", 4),           # w3
    ("fafaf", [20, 30, 1], "Sigmoid", 2),           # w4
    ("fafaf", [20, 30, 1], "Sigmoid", 1),           # w5
    ("fafaf", [32, 32, 1], "Tanh", 1),              # examples/09
    ("fa fa fa f", [48, 48, 48, 1], "Tanh", 1),     # examples/31
    ("fa fa f", [24, 24, 1], "Tanh", 1),            # examples/23, the beam
]


@pytest.mark.parametrize("layout,features,act,in_dim", KERNEL_CHAINS)
def test_mlp_plan_shared_memory_matches_the_source(host_lib, layout,
                                                   features, act, in_dim):
    # The wrapper's reckoning equals the source's mlp_smem_floats, the
    # chains take the full 128-point tile, and the block fits.
    plan, _ = _plan(layout, features, act, in_dim)
    assert plan.tile == 128
    assert plan.smem_bytes == host_lib.host_mlp_smem_bytes(
        *plan.kernel_args()) <= MAX_SHARED_BYTES


def test_mlp_kernel_threads_match_the_wrapper(host_lib):
    assert host_lib.host_mlp_threads() == fused_mlp.THREADS


def test_mlp_plan_refuses_a_chain_too_wide_for_shared_memory():
    net = make_layout_network("fa fa f", [300, 300, 1], "Tanh", in_dim=3)
    args = (net.tokens, net.activations, net.layer_shapes, 3)
    reason = fused_mlp.refusal(*args)
    assert reason is not None and "shared memory" in reason
    assert not fused_mlp.supports(*args)
    with pytest.raises(ValueError, match="shared memory"):
        fused_mlp.MlpPlan(*args)


@pytest.mark.parametrize("layout", ["fa f", "fa fa f", "fa fa fa f",
                                    "faR fa fa+ f", "faR faR fa+ fa+ f"])
def test_mlp_plan_takes_every_chain_the_first_design_took(layout):
    # The first kernel's rule, one 64-point block of weights and
    # (2 + stack) x wmax x 64 floats of state in shared memory: every such
    # chain, widths 1-256 by 3 and 1-4 inputs, is still taken.
    for width in range(1, 257, 3):
        for in_dim in (1, 2, 3, 4):
            features = [width] * (layout.count("f") - 1) + [1]
            net = make_layout_network(layout, features, "Tanh",
                                      in_dim=in_dim)
            ops, n_params, wmax, stack = fused_mlp._mlp_ops(
                net.tokens, net.activations, net.layer_shapes, in_dim)
            if 4 * (n_params + (2 + stack) * wmax * 64) <= MAX_SHARED_BYTES:
                assert fused_mlp.supports(net.tokens, net.activations,
                                          net.layer_shapes, in_dim), \
                    (layout, width, in_dim)
