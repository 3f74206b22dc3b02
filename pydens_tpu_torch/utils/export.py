"""Ahead-of-time model export: the serving/deployment artifact.

Counterpart of ``pydens_tpu/utils/export.py``.  A trained solution field
serializes through ``torch.export``: the network parameters and ``V``
variables are baked in as buffers copied to the CPU (a mesh- or
card-trained solver exports the same artifact), the batch dimension is
dynamic, and the artifact round-trips through bytes that load in any
process that has torch: the serving side needs neither pydens_tpu_torch,
the Python equation nor the training machinery.

Format: the port's magic ``PDTTORCHEXP1`` followed by ``torch.export.save``'s
archive of the exported program.  The payload is not StableHLO, so the
magic differs from ``pydens_tpu``'s ``PDTPUEXP1``, and neither package
loads the other's artifact.

Scope: the exported function is the plain inference path (network, ansatz
and V variables; an ensemble exports the member mean).  No CUDA kernel of
the package goes into the artifact, just as ``pydens_tpu`` keeps its
Pallas kernels out: the artifact holds only ATen operators, and loads
where the package's kernels were never built.  ``with_grad=True`` adds the
first derivatives, forward mode written out in plain operators for every
model (chains, embedded, modified, adaptive and branched networks,
LayerNorm layouts, module and custom models, separable models, callable
conditions, ensembles): the same ``model.apply`` runs on a
:class:`~pydens_tpu_torch.models.jets.Jet` for each input column, whose
tangent is that column's unit vector, the columns' rows stacked into one
batch.  An operator of the model outside the jets' table raises an error
that names it.
"""

from __future__ import annotations

import io

import numpy as np
import torch
from torch import nn

from ..models.jets import Jet
from ..ops.tokens import variable_scope
from ..solver import _skeleton, _tree_leaves

__all__ = ["export_model", "load_exported"]

_MAGIC = b"PDTTORCHEXP1"


class _Served(nn.Module):
    """The exported function: the parameters and V variables as buffers
    (CPU copies), the model's plain forward on them; float32 points in,
    float32 results out (a bfloat16 model's as float32, as ``predict``'s)."""

    def __init__(self, model, params, n_models, with_grad):
        super().__init__()
        self.model = [model]            # not a submodule: no live weights
        self.paths = []
        for i, (path, leaf) in enumerate(_tree_leaves(params)):
            self.register_buffer(f"p{i}", leaf.detach().to("cpu").clone())
            self.paths.append(path)
        self.skeleton = _skeleton(params)
        self.n_models = n_models
        self.with_grad = with_grad

    def forward(self, xs):
        model = self.model[0]
        params = _skeleton(self.skeleton)
        for i, path in enumerate(self.paths):
            node = params
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = getattr(self, f"p{i}")
        K, n = self.n_models, xs.shape[0]
        xs = xs.to(model.dtype)
        with variable_scope("read", params["variables"]):
            if not self.with_grad:
                rows = xs if K == 1 else xs.repeat(K, 1)
                return _member_mean(model.apply(params, rows), K).float()
            # One jet per input column a, xs + s e_a, their rows stacked
            # into one batch: block a carries column a's unit tangent.
            total = model.total
            eye = torch.eye(total, dtype=xs.dtype, device=xs.device)
            tangent = (xs.new_zeros((total, n, total))
                       + eye.unsqueeze(1)).reshape(-1, total)
            rows = xs.repeat(total, 1)
            if K > 1:
                rows, tangent = rows.repeat(K, 1), tangent.repeat(K, 1)
            out = model.apply(params, Jet([rows, tangent]))
        u = _member_mean(out.c[0], K)
        du = (torch.zeros_like(u) if out.c[1] is None
              else _member_mean(out.c[1].expand_as(out.c[0]), K))
        du = du.reshape(total, n, -1).transpose(0, 1)
        return u[:n].float(), du.float()


def _member_mean(t, K):
    """An ensemble's member-major rows ``(K * N, c)`` as their member mean
    ``(N, c)``; a single model's as they are."""
    return t if K == 1 else t.reshape(K, -1, t.shape[-1]).mean(0)


def export_model(solver, path=None, with_grad=False):
    """Serialize the trained solution ``u_theta`` to a portable artifact.

    Parameters
    ----------
    solver : Solver
        A (trained) solver; its current parameters are baked in.
    path : str | None
        If given, the artifact is written there; the bytes are returned
        either way.
    with_grad : bool
        If true, the artifact returns ``(u, du)`` with ``du`` of shape
        ``(N, total, n_out)``, the first derivatives
        (``Solver.predict_grad``'s fields), forward mode written out on
        jets.  A model that calls an operator outside the jets' table
        raises an error that names it.

    Returns
    -------
    bytes: a :func:`load_exported` artifact (magic + ``torch.export``
    archive).
    """
    from torch.export import Dim, export
    from torch.export.passes import move_to_device_pass

    model = solver.model
    params = model.params
    if params is None or params.get("net") is None:
        raise ValueError("solver has no parameters to export")
    served = _Served(model, params, solver.n_models, with_grad)
    # Traced on the model's device (constants of the model live there),
    # then every tensor of the program moved to the CPU.
    served.to(solver.device)
    example = torch.rand((8, model.total), device=solver.device)
    with torch.no_grad():
        program = export(served, (example,),
                         dynamic_shapes={"xs": {0: Dim("batch")}},
                         strict=False)
    if solver.device.type != "cpu":
        program = move_to_device_pass(program, "cpu")
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = _MAGIC + buf.getvalue()
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob


def load_exported(path_or_bytes, device=None):
    """Load an :func:`export_model` artifact into a plain callable.

    Accepts a path or the raw bytes; returns ``fn(xs) -> (N, n_out)``, or
    ``fn(xs) -> (u, du)`` with ``du`` of shape ``(N, total, n_out)`` for an
    artifact exported with ``with_grad=True``: torch tensors on ``device``
    (None: the card, as for ``Solver``; ``'cpu'`` for the CPU).  ``xs`` is
    any ``(N, ndims + nparams)`` array or tensor (the batch dimension is
    dynamic).  A process that has torch alone can do the same with
    ``torch.export.load`` of ``blob[len(b'PDTTORCHEXP1'):]``."""
    from torch.export.passes import move_to_device_pass
    from ..models.base import resolve_device

    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            blob = fh.read()
    if not blob.startswith(_MAGIC):
        raise ValueError("not a pydens_tpu_torch export artifact")
    device = resolve_device(device)
    program = torch.export.load(io.BytesIO(blob[len(_MAGIC):]))
    if device.type != "cpu":
        program = move_to_device_pass(program, device)
    module = program.module()

    def fn(xs):
        if not torch.is_tensor(xs):
            xs = torch.as_tensor(np.asarray(xs, np.float32))
        if xs.dim() != 2:
            raise ValueError(
                f"expected a (N, in_dim) batch, got {tuple(xs.shape)}")
        with torch.no_grad():
            return module(xs.to(device=device, dtype=torch.float32))

    return fn
