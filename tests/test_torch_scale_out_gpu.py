"""Data parallelism and the serving artifact on the card: a mesh of one
rank over NCCL, whose fit through captured CUDA graphs (the all-reduce
captured in the step) equals the same fit without a mesh, and an exported
artifact loaded on the card equal to ``predict`` (which runs the MLP
kernel).  Every test needs a CUDA card and skips without one.  The file
imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_scale_out_gpu.py
"""

import numpy as np
import pytest
import torch

import pydens_tpu_torch as pdt
from pydens_tpu_torch import D, Solver
from pydens_tpu_torch.ops import fused_mlp, fused_taylor

ODE = dict(ndims=1, initial_condition=.5, activation="Tanh",
           layout="fafaf", features=[12, 10, 1])


def _ode(f, x):
    return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and the kernels exist only "
                    "there")


@pytest.mark.gpu
def test_nccl_world_of_one_graph_fit_equals_fit_without_mesh():
    _require_cuda()
    from pydens_tpu_torch.parallel.mesh import destroy_local_world
    try:
        mesh = pdt.make_mesh()
        assert torch.distributed.get_backend() == "nccl"
        a = Solver(_ode, seed=0, **ODE)
        a.fit(niters=300, batch_size=256, lr=0.02, progress=False)
        before = fused_taylor.fused_taylor_forward.launches
        b = Solver(_ode, seed=0, mesh=mesh, **ODE)
        b.fit(niters=300, batch_size=256, lr=0.02, progress=False)
        step, = b._step_cache.values()
        assert step.graph is not None and step.replays == 299
        # One eager step and one capture launched the forward kernel.
        assert fused_taylor.fused_taylor_forward.launches - before == 2
    finally:
        destroy_local_world()
    la, lb = np.asarray(a.losses), np.asarray(b.losses)
    np.testing.assert_allclose(lb[:20], la[:20], rtol=1e-5)
    np.testing.assert_allclose(lb[-1], la[-1], rtol=1e-3)


@pytest.mark.gpu
def test_artifact_on_the_card_equals_predict():
    _require_cuda()
    s = Solver(_ode, seed=0, **ODE)
    s.fit(niters=300, batch_size=256, lr=0.02, progress=False)
    fn = pdt.load_exported(s.export())
    grad_fn = pdt.load_exported(s.export(with_grad=True))
    for n in (1, 1000, 1 << 20):
        xs = np.random.default_rng(n).uniform(size=(n, 1)).astype(
            np.float32)
        before = fused_mlp.fused_mlp_forward.launches
        want = s.predict(xs)
        assert fused_mlp.fused_mlp_forward.launches == before + 1
        out = fn(xs)
        assert out.device.type == "cuda"
        np.testing.assert_allclose(out.cpu().numpy(), want, rtol=2e-5,
                                   atol=2e-5)
        u, du = grad_fn(xs)
        np.testing.assert_allclose(du[:, :, 0].cpu().numpy(),
                                   s.predict_grad(xs), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(u.cpu().numpy(), want, rtol=2e-5,
                                   atol=2e-5)
