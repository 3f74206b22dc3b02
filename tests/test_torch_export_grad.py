"""``Solver.export(with_grad=True)`` for every model family: forward mode
written out on jets (``pydens_tpu_torch/models/jets.py``), held to
``pydens_tpu``'s artifact at the same theta and to the port's own
``predict_grad``; the jets' operator table held to ``torch.func.jvp``."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import pydens_tpu as jpdt
import pydens_tpu_torch as tpdt
from pydens_tpu_torch import D, Solver
from pydens_tpu_torch.models.jets import Jet

from export_grad_cases import FAMILIES, pair, points, port_artifact, served
from one_thread import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
U_TOL = dict(rtol=2e-5, atol=1e-6)
DU_TOL = dict(rtol=2e-3, atol=2e-5)
OWN_TOL = dict(rtol=2e-5, atol=2e-5)


def _close(got, want, tol, bfloat16):
    """``assert_allclose`` at ``tol``; for a bfloat16 model within two
    bfloat16 ulps of the largest magnitude (``2 ** -7`` of it): the two
    packages' plain bfloat16 forwards already differ by one ulp, and the
    port's own two routes round in different orders."""
    if bfloat16:
        tol = dict(rtol=0.0, atol=2.0 ** -7 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, **tol)


# Loads every family's artifact with torch alone (pydens_tpu_torch,
# pydens_tpu and jax unimportable) and checks u and du bit for bit against
# what it served here (tests/test_torch_export.py's
# test_export_holds_plain_operators_only checks each program's operators).
BARE = """
import io, json, sys
for mod in ("pydens_tpu_torch", "pydens_tpu", "jax"):
    sys.modules[mod] = None
import numpy as np
import torch
torch.set_num_threads(1)
out = {}
for name in sys.argv[2:]:
    blob = open(sys.argv[1] + "/" + name + ".pdtx", "rb").read()
    program = torch.export.load(io.BytesIO(blob[len(b"PDTTORCHEXP1"):]))
    ref = np.load(sys.argv[1] + "/" + name + ".npz")
    u, du = program.module()(torch.from_numpy(ref["xs"]))
    out[name] = dict(
        u=bool(np.array_equal(u.detach().numpy(), ref["u"])),
        du=bool(np.array_equal(du.detach().numpy(), ref["du"])))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def bare_torch(tmp_path_factory):
    # Every family's artifact first, then the bare process in the
    # background while the comparisons with pydens_tpu run.
    folder = tmp_path_factory.mktemp("bare_torch")
    for name in FAMILIES:
        (folder / f"{name}.pdtx").write_bytes(port_artifact(name))
        u, du = served(name)
        np.savez(folder / f"{name}.npz", xs=points(name), u=u, du=du)
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    proc = subprocess.Popen(
        [sys.executable, "-c", BARE, str(folder), *FAMILIES], env=env,
        cwd=folder, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_artifact_matches_pydens_tpu_and_predict_grad(name,
                                                             bare_torch):
    # The same theta and points through both packages' with_grad
    # artifacts: u within rtol 2e-5 / atol 1e-6, du within rtol 2e-3 /
    # atol 2e-5; the port's du within rtol/atol 2e-5 of its own
    # predict_grad, its u of predict.
    js, ts = pair(name)
    xs = points(name)
    tu, tdu = served(name)
    want = ts.predict(xs)
    assert tu.shape == want.shape and tu.dtype == np.float32
    assert tdu.shape == xs.shape + want.shape[-1:]
    assert tdu.dtype == np.float32
    ju, jdu = jpdt.load_exported(js.export(with_grad=True))(
        xs.astype(np.asarray(js.model.params["log_scale"]).dtype))
    ju, jdu = (np.asarray(ju, np.float32), np.asarray(jdu, np.float32))
    bf16 = ts.model.dtype == torch.bfloat16
    _close(tu, ju, U_TOL, bf16)
    _close(tdu, jdu, DU_TOL, bf16)
    _close(tu, want, OWN_TOL, bf16)
    own = ts.predict_grad(xs)
    _close(tdu.reshape(own.shape), own, OWN_TOL, bf16)


def _example_06():
    path = REPO / "examples_torch" / "06_custom_model.py"
    spec = importlib.util.spec_from_file_location("custom_model_06", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_custom_model_of_example_06_exports_its_derivative():
    # examples_torch/06's Model subclass (a residual tanh MLP written with
    # @ and +), its gate moved off 0: u of predict, du of predict_grad
    # within rtol/atol 2e-5.
    mod = _example_06()
    s = Solver(mod.ode, ndims=1, initial_condition=.5, model=mod.ResidualMLP,
               seed=0, device="cpu")
    with torch.no_grad():
        s.model.log_scale.fill_(0.3)
    xs = np.linspace(0, 1, 41, dtype=np.float32).reshape(-1, 1)
    u, du = tpdt.load_exported(s.export(with_grad=True), device="cpu")(xs)
    np.testing.assert_allclose(u.numpy(), s.predict(xs), **OWN_TOL)
    np.testing.assert_allclose(du.numpy()[:, :, 0], s.predict_grad(xs),
                               **OWN_TOL)


class _Cumprod(nn.Module):
    def __init__(self):
        super().__init__()
        self.hidden = nn.Linear(2, 4)

    def forward(self, x):
        return torch.cumprod(torch.tanh(self.hidden(x)), dim=-1)[:, -1:]


def test_operator_outside_the_table_is_named():
    # A module calling torch.cumprod, which the jets' table lacks:
    # with_grad raises NotImplementedError naming it; the plain artifact
    # exports and serves predict.
    def heat(f, x, t):
        return D(f, t) - D(D(f, x), x)

    s = Solver(heat, ndims=2, seed=0, device="cpu", initial_condition=0.0,
               model=tpdt.module_model(_Cumprod()))
    with pytest.raises(NotImplementedError, match=r"torch\.cumprod"):
        s.export(with_grad=True)
    pts = np.random.default_rng(0).uniform(size=(6, 2)).astype(np.float32)
    fn = tpdt.load_exported(s.export(), device="cpu")
    np.testing.assert_allclose(fn(pts).numpy(), s.predict(pts), rtol=1e-6,
                               atol=1e-6)


# -- the operator table, each rule against torch.func.jvp ---------------------
_G = torch.Generator().manual_seed(3)
_W = torch.randn(3, 4, generator=_G)
_B = torch.randn(4, generator=_G)
_M = torch.randn(2, 3, generator=_G)


def _layer_norm(x, weight=1.0, bias=0.0):
    # LayerNorm written out: torch's own nested jvp of F.layer_norm is not
    # the second derivative, so order 2 is held to this composition.
    xc = x - x.mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True)
                            + 1e-5) * weight + bias


# name: (function on jets and tensors alike, its reference where torch's
# jvp of the function itself is not the one to hold it to)
OPS = {
    "linear": lambda x: F.linear(x, _W.T, _B),
    "matmul": lambda x: x @ _W + _B,
    "rmatmul": lambda x: _M @ x.T,
    "addmm": lambda x: torch.addmm(_B, x, _W),
    "mm": lambda x: torch.mm(x, _W),
    "einsum": lambda x: torch.einsum("ni,ij->nj", x, _W),
    "einsum_two_jets": lambda x: torch.einsum("ni,ni->n", x, torch.sin(x)),
    "cat": lambda x: torch.cat([x, _B[:3].expand(4, 3), torch.sin(x)], 1),
    "stack": lambda x: torch.stack([x, torch.cos(x)], dim=0),
    "getitem": lambda x: x[1:, ::2],
    "views": lambda x: x.reshape(2, 6).unsqueeze(0).squeeze(0).view(
        12).expand(2, 12).permute(1, 0).transpose(0, 1).flatten(),
    "sum_mean": lambda x: x.sum(-1) + torch.mean(x, dim=0).sum(),
    "add_sub_neg": lambda x: 1.5 - x + (x - _B[:3]) - (-x) + _B[:3] + 2.0,
    "mul_div_const": lambda x: 3.0 * x * _B[:3] / 1.7 / _B[1:],
    "mul_jets": lambda x: x * torch.sin(x) * x,
    "div_jets": lambda x: torch.sin(x) / (1.5 + torch.cos(x)),
    "rdiv": lambda x: 2.0 / (1.5 + x * x),
    "pow": lambda x: (1.0 + x * x) ** 1.5 + torch.pow(x, 3),
    "rpow": lambda x: 2.0 ** x,
    "pow_jets": lambda x: (1.0 + x * x) ** torch.sin(x),
    "square_sqrt_rsqrt": lambda x: torch.square(x) + torch.sqrt(1.0 + x * x)
    + torch.rsqrt(4.0 + x),
    "exp_log": lambda x: torch.exp(x) + torch.expm1(x) + torch.log(3.0 + x)
    + torch.log1p(2.0 + x) + torch.log2(3.0 + x) + torch.log10(3.0 + x),
    "trig": lambda x: torch.sin(x) + torch.cos(x) + torch.tan(0.3 * x),
    "hyperbolic": lambda x: torch.sinh(x) + torch.cosh(x) + torch.tanh(x),
    "inverse_trig": lambda x: torch.arcsin(0.3 * x) + torch.arccos(0.2 * x)
    + torch.arctan(x),
    "atan2": lambda x: torch.atan2(x, 1.0 + x * x),
    "erf": torch.erf,
    "sigmoid": torch.sigmoid,
    "abs": lambda x: torch.abs(x) * x,
    "where": lambda x: torch.where(x > 0, x * x, torch.exp(x)),
    "maximum_minimum": lambda x: torch.maximum(x, torch.sin(x) + 0.5)
    + torch.minimum(x, _W[0, :3]),
    "clamp": lambda x: torch.clamp(x, -1.3, 0.9) + torch.clip(x, min=-0.2),
    "layer_norm": lambda x: F.layer_norm(x, (3,)),
    "layer_norm_affine": lambda x: F.layer_norm(x, (3,), _B[:3], _B[1:]),
    "gelu_exact": lambda x: F.gelu(x),
    "numpy_ufuncs": lambda x: np.sin(x) * np.float32(2.0) + np.exp(x)
    if isinstance(x, Jet) else torch.sin(x) * 2.0 + torch.exp(x),
}
OPS.update({f"act_{name}": act for name, act in
            __import__("pydens_tpu_torch.models.layout",
                       fromlist=["ACTIVATIONS"]).ACTIVATIONS.items()})
_REFERENCE = {"layer_norm": _layer_norm,
              "layer_norm_affine": lambda x: _layer_norm(x, _B[:3], _B[1:])}


def _inputs():
    # Off every kink (0, +-1 and 6 of the piecewise activations).
    x = (torch.linspace(-2.9, 2.9, 12) + 0.013).reshape(4, 3)
    g = torch.Generator().manual_seed(7)
    return x, torch.randn(4, 3, generator=g), torch.randn(4, 3, generator=g)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("name", list(OPS))
def test_each_rule_matches_jvp(name, order):
    # f on the jet of x + s t (+ r v) against torch.func.jvp (nested for the
    # mixed second partial): every coefficient within rtol 1e-5.
    fn = OPS[name]
    ref = _REFERENCE.get(name, fn) if order == 2 else fn
    x, t, v = _inputs()
    if order == 1:
        want = list(torch.func.jvp(ref, (x,), (t,)))
        out = fn(Jet([x, t]))
    else:
        def dv(z):
            return torch.func.jvp(ref, (z,), (v,))[1]
        want = [ref(x), torch.func.jvp(ref, (x,), (t,))[1], dv(x),
                torch.func.jvp(dv, (x,), (t,))[1]]
        out = fn(Jet([x, t, v, None]))
    assert isinstance(out, Jet) and len(out.c) == len(want)
    for got, w in zip(out.c, want):
        got = torch.zeros_like(w) if got is None else got.expand_as(w)
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6)


# The kinks: each rule's derivative where jax.jvp takes it.
KINKS = {
    "relu": (torch.relu, jax.nn.relu, [0.0]),
    "relu6": (F.relu6, jax.nn.relu6, [0.0, 6.0]),
    "leaky_relu": (F.leaky_relu, jax.nn.leaky_relu, [0.0]),
    "hardtanh": (F.hardtanh, jax.nn.hard_tanh, [-1.0, 1.0]),
    "elu": (F.elu, jax.nn.elu, [0.0]),
    "celu": (F.celu, jax.nn.celu, [0.0]),
    "selu": (F.selu, jax.nn.selu, [0.0]),
    "abs": (torch.abs, jnp.abs, [0.0]),
    "maximum": (lambda x: torch.maximum(x, torch.zeros_like(x)),
                lambda x: jnp.maximum(x, 0.0), [0.0]),
    "clamp": (lambda x: torch.clamp(x, -1.0, 1.0),
              lambda x: jnp.clip(x, -1.0, 1.0), [-1.0, 1.0]),
}


@pytest.mark.parametrize("name", list(KINKS))
def test_kinks_take_jax_derivative(name):
    fn, jfn, at = KINKS[name]
    x = np.asarray(at, np.float32)
    want = jax.jvp(jfn, (jnp.asarray(x),), (jnp.ones_like(x),))[1]
    out = fn(Jet([torch.from_numpy(x), torch.ones(len(at))]))
    np.testing.assert_allclose(out.c[1].numpy(), np.asarray(want), rtol=1e-6)


def test_every_family_loads_in_a_bare_torch_process(bare_torch):
    # Each family's program loads with torch alone and serves there what
    # it serves here, bit for bit.
    stdout, stderr = bare_torch.communicate(timeout=300)
    assert bare_torch.returncode == 0, stderr[-3000:]
    report = json.loads(stdout.strip().splitlines()[-1])
    assert sorted(report) == sorted(FAMILIES)
    for name, got in report.items():
        assert got == dict(u=True, du=True), (name, got)
