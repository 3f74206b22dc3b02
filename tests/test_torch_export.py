"""The serving artifact of pydens_tpu_torch (``Solver.export`` /
``load_exported``, ``torch.export``): the twin of tests/test_export.py,
held to ``predict`` / ``predict_grad`` and to pydens_tpu's artifact for the
same theta."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu_torch import D, Solver, params_from_jax

from export_grad_cases import FAMILIES, foreign_operators, port_solver
from one_thread import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
NET = dict(layout="fafaf", features=[12, 10, 1], activation="Tanh")


def _ode(pdt):
    def ode(f, x):
        return pdt.D(f, x) - 2 * np.pi * pdt.cos(2 * np.pi * x)
    return ode


def _trained_ode_solver():
    s = Solver(_ode(tpdt), ndims=1, initial_condition=0.5, seed=0,
               device="cpu", **NET)
    s.fit(niters=300, batch_size=128, progress=False)
    return s


@pytest.fixture(scope="module")
def trained():
    return _trained_ode_solver()


def _xs(n):
    return np.linspace(0, 1, n, dtype=np.float32).reshape(-1, 1)


def test_export_roundtrip_matches_predict(trained, tmp_path):
    path = tmp_path / "u.pdtx"
    blob = trained.export(path)
    assert path.read_bytes() == blob
    assert blob.startswith(b"PDTTORCHEXP1")
    fn = tpdt.load_exported(path, device="cpu")
    # The batch dimension is dynamic: 1, 7 and 1,000 points.
    for n in (1, 7, 1000):
        out = fn(_xs(n))
        assert torch.is_tensor(out) and out.shape == (n, 1)
        np.testing.assert_allclose(out.numpy(), trained.predict(_xs(n)),
                                   rtol=1e-6, atol=1e-6)
    # A tensor in, a tensor out; any other rank is refused.
    np.testing.assert_allclose(fn(torch.from_numpy(_xs(5))).numpy(),
                               trained.predict(_xs(5)), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match=r"expected a \(N, in_dim\) batch"):
        fn(np.zeros(5, np.float32))


def test_export_bakes_in_v_variables():
    # The artifact carries the trained V variables, not their init values.
    def ode(f, x):
        return D(f, x) - tpdt.V("slope", 0.0)

    s = Solver(ode, ndims=1, initial_condition=0.0, seed=0, device="cpu",
               constraints=lambda f, x: f(np.array([1.0])) - 3.0)
    s.fit(niters=500, batch_size=64, lr=0.05,
          loss_terms=["equation", "constraint_0"], progress=False)
    fn = tpdt.load_exported(s.export(), device="cpu")
    np.testing.assert_allclose(fn(_xs(11)).numpy(), s.predict(_xs(11)),
                               rtol=1e-6, atol=1e-6)
    assert abs(float(fn(np.ones((1, 1), np.float32))[0, 0]) - 3.0) < 0.3


def test_export_ensemble_is_member_mean():
    s = Solver(_ode(tpdt), ndims=1, initial_condition=0.5, seed=0,
               n_models=3, layout="fa f", features=[8, 1], device="cpu")
    s.fit(niters=50, batch_size=64, progress=False)
    fn = tpdt.load_exported(s.export(), device="cpu")
    np.testing.assert_allclose(fn(_xs(9)).numpy(), s.predict(_xs(9)),
                               rtol=1e-6, atol=1e-6)


def test_export_mesh_trained_solver_is_topology_free():
    # A solver trained on a mesh exports an artifact that holds no process
    # group and loads where there is none: its buffers are CPU copies.
    from pydens_tpu_torch.parallel.mesh import destroy_local_world
    try:
        s = Solver(_ode(tpdt), ndims=1, initial_condition=0.5, seed=0,
                   mesh=tpdt.make_mesh(device="cpu"), layout="fa f",
                   features=[8, 1], device="cpu")
        s.fit(niters=50, batch_size=64, progress=False)
        blob = s.export()
    finally:
        destroy_local_world()
    assert not torch.distributed.is_initialized()
    import io
    program = torch.export.load(io.BytesIO(blob[len(b"PDTTORCHEXP1"):]))
    assert {t.device.type for t in program.state_dict.values()} == {"cpu"}
    fn = tpdt.load_exported(blob, device="cpu")
    np.testing.assert_allclose(fn(_xs(9)).numpy(), s.predict(_xs(9)),
                               rtol=1e-6, atol=1e-6)


def test_export_holds_plain_operators_only(trained):
    # The counterpart of "lowered for every platform": no kernel of the
    # package in the program, only ATen operators, so it runs on the CPU
    # and the card alike.  So for every family's with_grad program (its
    # derivative written out on jets); an ensemble's also holds arithmetic
    # on the symbolic batch size (K times the batch).
    import io
    program = torch.export.load(io.BytesIO(
        trained.export(with_grad=True)[len(b"PDTTORCHEXP1"):]))
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    assert targets and all(t.startswith("aten.") for t in targets), targets
    for name in FAMILIES:
        blob = port_solver(name).export(with_grad=True)
        assert foreign_operators(blob) == [], name


def test_export_untrained_solver_requires_params(monkeypatch):
    s = Solver(_ode(tpdt), ndims=1, initial_condition=0.5, seed=0,
               device="cpu", **NET)
    monkeypatch.setattr(s.model, "network_params", lambda: None)
    with pytest.raises(ValueError, match="no parameters"):
        s.export()


def test_artifact_loads_in_bare_torch_process(trained, tmp_path):
    # The serving side needs torch only: the raw torch.export archive after
    # the magic, in a process where pydens_tpu_torch (and jax) cannot be
    # imported.
    path = tmp_path / "u.pdtx"
    trained.export(path)
    expected = trained.predict(_xs(1000))
    np.save(tmp_path / "expected.npy", expected)
    code = f"""
import io, sys
for name in ("pydens_tpu_torch", "pydens_tpu", "jax"):
    sys.modules[name] = None
import numpy as np
import torch
blob = open({str(path)!r}, "rb").read()
assert blob.startswith(b"PDTTORCHEXP1")
fn = torch.export.load(io.BytesIO(blob[len(b"PDTTORCHEXP1"):])).module()
xs = torch.linspace(0, 1, 1000).reshape(-1, 1)
out = fn(xs).detach().numpy()
want = np.load({str(tmp_path / "expected.npy")!r})
assert np.abs(out - want).max() < 1e-5, np.abs(out - want).max()
print("OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout


def test_export_with_grad_matches_predict_grad(trained):
    fn = tpdt.load_exported(trained.export(with_grad=True), device="cpu")
    u, du = fn(_xs(11))
    assert du.shape == (11, 1, 1)
    np.testing.assert_allclose(u.numpy(), trained.predict(_xs(11)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(du.numpy()[:, :, 0],
                               trained.predict_grad(_xs(11)), rtol=1e-5,
                               atol=1e-5)


def test_export_branched_layout_roundtrip(tmp_path):
    # Branch sub-network params (br1_*) and multi-head outputs survive.
    def system(f, x):
        u, v = f[:, 0:1], f[:, 1:2]
        return (D(u, x) - v, D(v, x) + u)

    s = Solver(system, ndims=1, seed=0, activation="Tanh",
               layout="fa B f .", features=[12, 1],
               branches=[dict(layout="f", features=[1])],
               initial_condition=np.array([0.0, 1.0]), device="cpu")
    s.fit(niters=30, batch_size=32, progress=False)
    xs = np.linspace(0, 1, 21, dtype=np.float32)
    want = s.predict(xs)
    assert want.shape == (21, 2)
    fn = tpdt.load_exported(s.export(str(tmp_path / "branched.bin")),
                            device="cpu")
    np.testing.assert_allclose(fn(xs.reshape(-1, 1)).numpy(), want,
                               rtol=1e-5, atol=1e-6)


def _jax_twin(n_models=1):
    """pydens_tpu's ODE solver (its gate's log_scale moved off 0) and the
    port's with its theta."""
    js = jpdt.Solver(_ode(jpdt), ndims=1, initial_condition=0.5, seed=0,
                     n_models=n_models, **NET)
    js.model.params["log_scale"] = js.model.params["log_scale"] + 0.3
    ts = Solver(_ode(tpdt), ndims=1, initial_condition=0.5, seed=0,
                n_models=n_models, device="cpu", **NET)
    ts.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      js.model.params)))
    return js, ts


@pytest.mark.parametrize("n_models", [1, 2])
def test_artifact_matches_pydens_tpu_artifact(n_models):
    # The same theta through both packages' artifacts: u within rtol 2e-5 /
    # atol 1e-6, du within rtol 2e-3 / atol 2e-5.
    js, ts = _jax_twin(n_models)
    xs = np.random.default_rng(3).uniform(size=(257, 1)).astype(np.float32)
    ju, jdu = jpdt.load_exported(js.export(with_grad=True))(xs)
    tu, tdu = tpdt.load_exported(ts.export(with_grad=True), device="cpu")(xs)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tdu.numpy(), np.asarray(jdu), rtol=2e-3,
                               atol=2e-5)
    np.testing.assert_allclose(
        tpdt.load_exported(ts.export(), device="cpu")(xs).numpy(),
        np.asarray(ju), rtol=2e-5, atol=1e-6)


def test_each_package_refuses_the_other_artifact():
    js, ts = _jax_twin()
    with pytest.raises(ValueError,
                       match="not a pydens_tpu_torch export artifact"):
        tpdt.load_exported(js.export(), device="cpu")
    with pytest.raises(ValueError, match="not a pydens_tpu export artifact"):
        jpdt.load_exported(ts.export())
