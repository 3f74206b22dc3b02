"""Multi-process training support, on ``torch.distributed``.

Counterpart of ``pydens_tpu/parallel/distributed.py``.  PyTorch runs one
process per card (one *rank*), so the multi-controller contract of the JAX
package holds here as it is: every process calls :func:`initialize` first,
then builds the same meshes (``make_mesh()``) and drives the same
``Solver`` calls in lockstep.  The training step already keeps every rank
in step: each draws the same full batch from the same seed and keeps its
slice, and the loss and gradient are summed over the ranks once a step.

* :func:`initialize` joins the process group (``tcp://`` rendezvous; NCCL
  with each rank on ``cuda:<local rank>``, or gloo for CPU ranks);
* :func:`to_global_replicated` makes host state identical on every rank
  (rank 0's values, broadcast);
* :func:`global_batch` is this rank's slice of a full host batch;
* :func:`fetch` brings a tree of tensors to host numpy.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "is_multi_process", "to_global_replicated",
           "global_batch", "fetch"]


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device=None, **kwargs):
    """Join the multi-process group (call before any mesh is made).

    ``coordinator_address`` is ``'host:port'`` of rank 0's rendezvous (any
    free port); ``num_processes`` the world size and ``process_id`` this
    process's rank.  Without them the ``env://`` variables of a launcher
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) are read.
    ``device=None`` means the cards: NCCL, each rank on ``cuda:<local
    rank>`` (``LOCAL_RANK`` of a launcher, else the rank modulo the cards
    on the host); ``device='cpu'`` means gloo.  Other keyword
    arguments go to ``torch.distributed.init_process_group``."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if coordinator_address is None:
        init_method = "env://"
        num_processes = (int(os.environ["WORLD_SIZE"])
                         if num_processes is None else num_processes)
        process_id = (int(os.environ["RANK"]) if process_id is None
                      else process_id)
    else:
        init_method = f"tcp://{coordinator_address}"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            **kwargs)


def is_multi_process(mesh):
    """True iff the mesh spans more than one rank (one process each)."""
    return mesh.size() > 1


def _mesh_group(mesh):
    from .mesh import axis_group
    return axis_group(mesh, mesh.mesh_dim_names)[0]


def _device(mesh):
    return torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")


def to_global_replicated(tree, mesh, check=False):
    """The leaves of ``tree`` (tensors, numpy arrays or numbers) as tensors
    on this rank's device, equal on every rank of ``mesh``: the values of
    the mesh's first rank, broadcast.  With ``check``, a rank whose own
    values differ from them raises ``ValueError`` on every rank (a debug
    aid: deterministic same-seed code gives equal values already)."""
    group = _mesh_group(mesh)
    src = int(mesh.mesh.min())
    dev = _device(mesh)

    def conv(leaf):
        t = torch.as_tensor(leaf).to(dev).clone()
        own = t.clone()
        dist.broadcast(t, src=src, group=group)
        if check:
            bad = torch.tensor([float(not torch.equal(t, own))], device=dev)
            dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=group)
            if bad.item():
                raise ValueError(
                    "to_global_replicated: the ranks of the mesh hold "
                    "different values")
        return t

    return _map(conv, tree)


def global_batch(mesh, pts):
    """This rank's contiguous slice of the full batch ``pts`` (rows; the
    same on every rank, drawn from the same seed) over the mesh's data
    axes (every axis but ``'models'``) jointly, as ``Solver(mesh=)``
    slices its batches.  The batch must divide by their size."""
    from .mesh import axis_group
    names = tuple(a for a in mesh.mesh_dim_names if a != "models")
    _, size, index = axis_group(mesh, names)
    n = pts.shape[0]
    if n % size:
        raise ValueError(f"a batch of {n} does not divide over the data "
                         f"mesh axes {names} of total size {size}")
    step = n // size
    return pts[index * step:(index + 1) * step]


def fetch(tree):
    """A tree of tensors (parameters of a mesh-trained solver, say) as host
    numpy arrays, e.g. to hand to a single-process serving job.  Works on
    every rank."""
    from ..ops.tokens import to_host
    return _map(lambda t: to_host(t) if torch.is_tensor(t)
                else np.asarray(t), tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)
