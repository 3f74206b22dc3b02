"""The model families of tests/export_families.py at 8 wide, shared by
tests/test_torch_export_grad.py and tests/test_torch_export.py: each a
pair of solvers, ``pydens_tpu``'s and the port's, at one theta (every
leaf moved off its initial value), with seeded points in the domain."""

import functools

import jax
import numpy as np
import torch

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu_torch.interop import module_params_from_flax

from export_families import SPECIFIC, families


def _flax_module(width, depth):
    """``pydens_tpu``'s twin of ``export_families.torch_net``."""
    import flax.linen as fnn
    from pydens_tpu.models.flax_adapter import flax_model

    class FlaxNet(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            for _ in range(depth):
                x = fnn.tanh(fnn.Dense(width)(x))
            return fnn.Dense(1)(x)
    return flax_model(FlaxNet())


SPECIFIC[jpdt] = dict(module=_flax_module, bfloat16=jax.numpy.bfloat16)
FAMILIES = families()


def _shifted(tree, seed=11):
    """Every leaf of a JAX parameter tree moved off its initial value by a
    seeded draw (a slope off ``1/n``, a LayerNorm scale off 1, the gate's
    ``log_scale`` off 0), as float32 numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(np.asarray(a, np.float32)
                             + 0.1 * rng.standard_normal(np.shape(a)),
                             np.float32), tree)


@functools.lru_cache(maxsize=None)
def pair(name):
    """``pydens_tpu``'s and the port's solver of one family at one
    theta."""
    eq, opts = FAMILIES[name]
    js = jpdt.Solver(eq(jpdt), seed=0, **opts(jpdt))
    theta = _shifted(js.model.params)
    dtype = js.model.dtype
    js.model.params = jax.tree.map(lambda a: jax.numpy.asarray(a, dtype),
                                   theta)
    ts = tpdt.Solver(eq(tpdt), seed=0, device="cpu", **opts(tpdt))
    tdtype = ts.model.dtype
    if name == "module":
        net = module_params_from_flax(theta["net"], ts.model.module,
                                      dtype=tdtype)
        ts.model.load_params({"net": net, "log_scale": torch.tensor(
            theta["log_scale"]), "variables": {}})
    else:
        ts.model.load_params(tpdt.params_from_jax(theta, dtype=tdtype))
    return js, ts


def port_solver(name):
    """The port's solver of one family at its own seeded initial theta
    (no JAX twin)."""
    eq, opts = FAMILIES[name]
    return tpdt.Solver(eq(tpdt), seed=0, device="cpu", **opts(tpdt))


def points(name, n=65, seed=5):
    """Seeded points in the family's domain, float32 ``(n, total)``."""
    _, ts = pair(name)
    lo = np.array([d[0] for d in ts.model.domain], np.float32)
    hi = np.array([d[1] for d in ts.model.domain], np.float32)
    u = np.random.default_rng(seed).uniform(size=(n, len(lo)))
    return (lo + (hi - lo) * u).astype(np.float32)


@functools.lru_cache(maxsize=None)
def port_artifact(name):
    """The port's ``with_grad`` artifact of one family."""
    return pair(name)[1].export(with_grad=True)


@functools.lru_cache(maxsize=None)
def served(name):
    """``(u, du)`` the port's artifact serves at :func:`points`, as
    numpy."""
    u, du = tpdt.load_exported(port_artifact(name), device="cpu")(
        points(name))
    return u.numpy(), du.numpy()


def foreign_operators(blob):
    """The operators of an artifact's program that are not ATen's
    (arithmetic on the symbolic batch size aside)."""
    import io
    program = torch.export.load(io.BytesIO(blob[len(b"PDTTORCHEXP1"):]))
    shape_math = (torch.SymInt, torch.SymBool, torch.SymFloat, int, float,
                  bool)
    return sorted({str(n.target) for n in program.graph.nodes
                   if n.op == "call_function"
                   and not isinstance(n.meta.get("val"), shape_math)
                   and not str(n.target).startswith("aten.")})
