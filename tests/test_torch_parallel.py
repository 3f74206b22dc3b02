"""Data parallelism of pydens_tpu_torch (``make_mesh``, ``Solver(mesh=)``,
``parallel.distributed``) on a group of four gloo ranks, held to the same
fits in one process and to pydens_tpu's 8-device mesh.

One module-scoped fixture starts the group once: four processes of
``tests/parallel_cases.py`` rendezvous on a port taken by binding port 0,
run every scenario and write each rank's results; meanwhile this process
runs the same scenarios without a mesh.  The tests read both, one case
each, with the JAX tests' bounds (tests/test_parallel.py,
test_mesh_feature_matrix.py, test_distributed.py, test_gauss_newton.py,
test_separable.py)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt

sys.path.insert(0, str(Path(__file__).resolve().parent))
import parallel_cases as cases  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = 120


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _jax_solver():
    return jpdt.Solver(lambda f, x: jpdt.D(f, x) - 2 * np.pi * jpdt.cos(
        2 * np.pi * x), ndims=1, initial_condition=.5, seed=0, **cases.NET)


def _write_jax_theta(path):
    """pydens_tpu's initial theta of the parity case and its fixed batch."""
    js = _jax_solver()
    leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, js.model.params))
    arrays = {"/".join(k.key for k in keys): np.asarray(v)
              for keys, v in leaves}
    arrays["pts"] = np.random.default_rng(7).uniform(
        size=(64, 1)).astype(np.float32)
    np.savez(path, **arrays)
    return js, arrays["pts"]


def _jax_separable(name):
    """pydens_tpu's solver of a causal separable case, and the causal
    triple of its time axis."""
    _, kw, t_axis = cases.SEPARABLE_CAUSAL[name]
    jeq = {"separable_causal": lambda f, x, t: jpdt.D(f, t) - 1e-4 * jpdt.D(
               jpdt.D(f, x), x) - 5.0 * (f - f ** 3),
           "separable_causal_t0": lambda f, t, x: jpdt.D(f, t) - 0.05
           * jpdt.D(jpdt.D(f, x), x) - f * (1.0 - f ** 2)}[name]
    if "initial_condition" in kw:
        kw = dict(kw, initial_condition=lambda x: x ** 2 * jpdt.cos(
            np.pi * x))
    js = jpdt.Solver(jeq, model=jpdt.SeparableModel, seed=0, **kw,
                     **cases.SEPARABLE_NET)
    t_idx = js.model.ndims - 1 if t_axis is None else t_axis
    lo, hi = js.model.domain[t_idx]
    return js, (t_idx, float(lo), float(hi))


def _write_jax_separable(path, name):
    """pydens_tpu's theta of a causal separable case and a fixed grid batch
    of 16 samples an axis inside its domain."""
    js, _ = _jax_separable(name)
    leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, js.model.params))
    arrays = {"/".join(k.key for k in keys): np.asarray(v)
              for keys, v in leaves}
    dom = np.asarray(js.model.domain, np.float32)
    arrays["pts"] = (dom[:, 0] + (dom[:, 1] - dom[:, 0])
                     * np.random.default_rng(3).uniform(
                         size=(16, len(dom)))).astype(np.float32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    js, pts = _write_jax_theta(out / "jax_theta.npz")
    for name in cases.SEPARABLE_CAUSAL:
        _write_jax_separable(out / f"jax_{name}.npz", name)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "parallel_cases.py"),
         str(rank), str(port), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(cases.RANKS)]
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            single = cases.run_single()
        finally:
            torch.set_num_threads(threads)
        logs = [p.communicate(timeout=GROUP_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(cases.RANKS)]
    return dict(ranks=ranks, single=single, js=js, pts=pts, out=out)


def _close(a, b, rtol, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


# Each scenario's bound: JAX's for its case (mesh trajectory against the
# single-device one).
BOUNDS = {
    "data1d": 1e-4, "samplers": 1e-4, "models_data": 1e-4, "dcn_data": 1e-4,
    "until_loss": 2e-4, "adaptive": 2e-4, "rba": 2e-4, "causal": 2e-4,
    "ntk": 2e-4, "grad_balancing": 2e-4, "lm": 1e-3, "lbfgs": 1e-3,
    "separable": 2e-4, "separable_causal": 2e-4, "separable_causal_t0": 2e-4,
}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_group_fit_matches_one_process(group, name):
    # Four ranks, each its slice of the batch, one sum a step: the same
    # trajectory as one process, and every rank records the same one.
    mesh, single = group["ranks"][0][name], group["single"][name]
    for rank in group["ranks"][1:]:
        assert rank[name] == mesh
    for key in ("losses", "device", "host"):
        if key in single:
            assert len(mesh[key]) == len(single[key])
            _close(mesh[key], single[key], BOUNDS[name],
                   1e-8 if name == "lm" else 1e-6)
    if name == "data1d":
        _close(mesh["pred"], single["pred"], 0, 1e-5)
    if name == "until_loss":
        assert 0 < len(single["losses"]) < 4000
        assert mesh["converged_at"] == single["converged_at"]
        assert mesh["losses"][-1] <= 5e-2
    if name in ("ntk", "grad_balancing"):
        _close(mesh["weights"], single["weights"], 2e-4)
    if name == "models_data":
        # Members sharded 2-way, the batch 2-way; predict sees all four.
        assert np.asarray(mesh["all"]).shape == (4, 9, 1)
        _close(mesh["all"], single["all"], 1e-4, 1e-5)
        assert np.isfinite(mesh["std"]).all()
    if name == "dcn_data":
        # The batch divides over the product of 'dcn' and 'data'.
        assert (single["rows"], mesh["rows"]) == (256, 64)


def test_group_guard_stops_at_the_same_step(group):
    mesh, single = group["ranks"][0]["guard"], group["single"]["guard"]
    assert mesh == single
    assert mesh["stopped"] is not None and mesh["n"] < 400 and mesh["warned"]


def test_group_one_checkpoint_writer(group):
    # Each rank named its own file; only the first rank's exists, every
    # rank restored it, and the restored fit continues the saving one.
    for rank in group["ranks"]:
        ck = rank["checkpoint"]
        assert ck["written"] == ["ckpt.p0"]
        assert ck["n_loaded"] == 20
        _close(ck["resumed"], ck["saving"], 1e-5, 1e-7)


ERRORS = {
    "batch": ("ValueError", r"batch_size=10 must be divisible by the data "
              r"mesh axes \('data',\) total size 4"),
    "n_models": ("ValueError", "n_models=3 must be divisible by the "
                 "'models' mesh axis size 2"),
    "data_axes": ("ValueError", r"data mesh axes \('data',\)"),
    "dcn_total": ("ValueError", "total size 4"),
    "axis_names": ("ValueError", "axis_names must name every axis"),
    "shape_devices": ("ValueError", "needs 16 devices but only 4 are "
                      "available"),
    "n_devices": ("ValueError", "requested 100 devices but only 4 are "
                  "available"),
}


@pytest.mark.parametrize("key", sorted(ERRORS))
def test_group_checks_raise_jax_messages(group, key):
    import re
    kind, pattern = ERRORS[key]
    for rank in group["ranks"]:
        got = rank["errors"][key]
        assert got is not None and got.startswith(kind + ":"), got
        assert re.search(pattern, got), got
    assert group["ranks"][0]["errors"]["subset_size"] == 2


def test_group_loss_and_grad_equal_pydens_tpu_mesh(group):
    # A fixed theta (pydens_tpu's) and batch: the four ranks' summed loss
    # and gradient equal pydens_tpu's on its 8-device mesh (the batch
    # sharded over the mesh by a sharding constraint).
    js, pts = group["js"], group["pts"]
    mesh = jpdt.make_mesh()
    assert mesh.size == 8
    crit = lambda a, b: jnp.mean((a - b) ** 2)  # noqa: E731
    loss_fn, *_ = js._build_loss_fn((("equation", 1.0),), crit,
                                    use_plan=True)
    leaves = [jax.device_put(jnp.asarray(pts[:, i:i + 1]),
                             NamedSharding(mesh, P("data", None)))
              for i in range(pts.shape[1])]
    loss, grad = jax.jit(jax.value_and_grad(loss_fn))(js.model.params,
                                                      leaves)
    flat = np.concatenate([np.ravel(np.asarray(g))
                           for g in jax.tree.leaves(grad)])
    for rank in group["ranks"]:
        got = rank["jax_parity"]
        assert got["rows"] == 16
        np.testing.assert_allclose(got["loss"], float(loss), rtol=2e-5)
        np.testing.assert_allclose(got["grad"], flat, rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("name", sorted(cases.SEPARABLE_CAUSAL))
def test_group_causal_separable_loss_and_grad_equal_pydens_tpu_mesh(
        group, name):
    # Causal training of a separable model on a mesh, time on grid axis 1
    # and on the split axis 0: at pydens_tpu's theta and a fixed grid
    # batch, the four ranks' summed loss and gradient (each rank its rows
    # of grid axis 0, the slice means made global by one more all-reduce)
    # equal pydens_tpu's with grid axis 0 sharded over its 8-device mesh.
    js, causal = _jax_separable(name)
    pts = np.load(group["out"] / f"jax_{name}.npz")["pts"]
    mesh = jpdt.make_mesh()
    crit = lambda a, b: jnp.mean((a - b) ** 2)  # noqa: E731
    loss_fn, *_ = js._build_loss_fn((("equation", 1.0),), crit,
                                    use_plan=False, causal=causal)
    total = pts.shape[1]
    leaves = [jnp.asarray(pts[:, c]).reshape(
        (1,) * c + (-1,) + (1,) * (total - c)) for c in range(total)]
    leaves[0] = jax.device_put(leaves[0], NamedSharding(
        mesh, P("data", *(None,) * total)))
    loss, grad = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, leaves, None, None,
                          jnp.float32(cases.CAUSAL_EPS))))(js.model.params)
    flat = np.concatenate([np.ravel(np.asarray(g))
                           for g in jax.tree.leaves(grad)])
    for rank in group["ranks"]:
        got = rank["jax_parity_causal"][name]
        assert got["collectives"] == 1      # the slice means' all-reduce
        np.testing.assert_allclose(got["loss"], float(loss), rtol=2e-5)
        np.testing.assert_allclose(got["grad"], flat, rtol=2e-3, atol=2e-5)


def test_world_of_one_mesh_fit_equals_fit_without_mesh():
    # make_mesh() with no process group starts a world of one (gloo on the
    # CPU, no address or environment); a fit on it is the fit without.
    from pydens_tpu_torch.parallel import distributed
    from pydens_tpu_torch.parallel.mesh import destroy_local_world
    assert not torch.distributed.is_initialized()
    try:
        mesh = tpdt.make_mesh(device="cpu")
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",)
        assert not distributed.is_multi_process(mesh)
        kw = dict(ndims=1, initial_condition=.5, seed=0, device="cpu",
                  **cases.NET)
        a = tpdt.Solver(cases._ode, **kw)
        a.fit(niters=30, batch_size=64, lr=0.02, progress=False)
        b = tpdt.Solver(cases._ode, mesh=mesh, **kw)
        b.fit(niters=30, batch_size=64, lr=0.02, progress=False)
        assert a.losses == b.losses
        tree = distributed.to_global_replicated(
            {"a": np.arange(4, dtype=np.float32), "b": 2.0}, mesh,
            check=True)
        np.testing.assert_array_equal(tree["a"].numpy(), np.arange(4))
        assert float(tree["b"]) == 2.0
        fetched = distributed.fetch(b.params)
        assert isinstance(fetched["net"]["fc1"]["w"], np.ndarray)
        np.testing.assert_array_equal(
            distributed.global_batch(mesh, np.arange(8)), np.arange(8))
        if not torch.cuda.is_available():
            # Without device='cpu' a mesh is of the card's ranks.
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tpdt.make_mesh()
    finally:
        destroy_local_world()
    assert not torch.distributed.is_initialized()
