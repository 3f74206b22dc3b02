"""Device meshes for data-parallel PINN training, on ``torch.distributed``.

Counterpart of ``pydens_tpu/parallel/mesh.py``.  PyTorch runs one process
per card, so a "device" of the JAX package's mesh is a *rank* here: a mesh
is a :class:`torch.distributed.device_mesh.DeviceMesh` over ranks of the
default process group.  The workload is data-parallel over collocation
points: every rank draws the same full batch and keeps its slice, the
parameters stay replicated, and one all-reduce a step sums the ranks'
shares of the loss and its gradient (``Solver(mesh=...)``).  An axis named
``'models'`` shards ensemble members instead.

``pydens_tpu``'s ``batch_sharding`` and ``replicated`` are JAX sharding
objects (``NamedSharding``): the port places nothing by sharding
annotations, so they have no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "axis_group", "destroy_local_world"]

# The world of one that make_mesh started, if it did (a HashStore group).
_LOCAL_WORLD = []
# Process groups over slices of meshes, keyed by (world, ranks): new_group
# is collective over the world, so every rank makes them in the same order.
_GROUPS = {}


def _device_type(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pydens_tpu_torch runs on the card by "
                "default; pass device='cpu' for a mesh over CPU ranks")
        return "cuda"
    return torch.device(device).type


def _world(device_type):
    """The default process group, started as a world of one (NCCL on the
    card, gloo on the CPU; no address and no environment needed) when none
    exists."""
    if dist.is_initialized():
        backend = dist.get_backend()
        if device_type == "cuda" and backend == "gloo":
            raise ValueError(
                "the default process group is gloo (CPU ranks); pass "
                "device='cpu' to make_mesh, or initialize NCCL for the card")
        return dist.get_world_size()
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    _LOCAL_WORLD.append(dist.group.WORLD)
    return 1


def destroy_local_world():
    """Destroy the default process group if :func:`make_mesh` started it
    (a world of one), so that a later mesh starts afresh."""
    if _LOCAL_WORLD and dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL_WORLD.clear()
    _GROUPS.clear()


def make_mesh(n_devices=None, axis_name="data", devices=None, shape=None,
              axis_names=None, device=None):
    """Create a mesh of ranks for parallel training.

    1-D (default): the collocation batch is sharded over ``axis_name``
    (data parallelism).  N-D: pass ``shape`` and ``axis_names``: an axis
    named ``'models'`` shards ensemble members (``Solver(n_models=K)``)
    across ranks, composing ensemble parallelism with data parallelism::

        mesh = make_mesh(shape=(2, 4), axis_names=("models", "data"))
        Solver(pde, ..., n_models=8, mesh=mesh)

    Parameters
    ----------
    n_devices : int, optional
        Number of ranks of a 1-D mesh (default: every rank of the world).
    axis_name : str
        1-D mesh axis name.
    devices : sequence of int, optional
        Explicit rank list (default ``range(world_size)``).
    shape : tuple of int, optional
        N-D mesh shape; its product selects that many ranks.
    axis_names : tuple of str, optional
        One name per mesh axis (required with ``shape``).
    device : str or torch.device, optional
        ``None`` means the card (NCCL), ``'cpu'`` CPU ranks (gloo).  With no
        process group yet a world of one is started, so that
        ``Solver(mesh=make_mesh())`` works in one process; several ranks
        join one world first (:func:`~pydens_tpu_torch.parallel.
        distributed.initialize`), and every rank makes the same meshes in
        the same order.
    """
    device_type = _device_type(device)
    world = _world(device_type)
    ranks = list(devices if devices is not None else range(world))
    if shape is not None:
        if axis_names is None or len(axis_names) != len(shape):
            raise ValueError("axis_names must name every axis of `shape`")
        need = int(np.prod(shape))
        if need > len(ranks):
            raise ValueError(
                f"mesh shape {tuple(shape)} needs {need} devices but only "
                f"{len(ranks)} are available")
        grid = torch.tensor(ranks[:need]).reshape(tuple(shape))
        return DeviceMesh(device_type, grid,
                          mesh_dim_names=tuple(axis_names))
    if n_devices is not None:
        if n_devices > len(ranks):
            raise ValueError(
                f"requested {n_devices} devices but only "
                f"{len(ranks)} are available")
        ranks = ranks[:n_devices]
    return DeviceMesh(device_type, torch.tensor(ranks),
                      mesh_dim_names=(axis_name,))


def axis_group(mesh, names):
    """``(group, size, index)`` of this rank's slice of ``mesh`` over the
    axes ``names`` jointly: the process group of the ranks that share this
    rank's coordinates on every other axis, their number, and this rank's
    position among them (row-major over ``names``).  ``group`` is None for
    the whole world.  Every rank of the world must call it in the same
    order (``torch.distributed.new_group`` is collective)."""
    dims = [mesh.mesh_dim_names.index(a) for a in names]
    rest = [d for d in range(mesh.ndim) if d not in dims]
    grid = mesh.mesh.permute(rest + dims).reshape(
        -1, int(np.prod([mesh.mesh.shape[d] for d in dims])))
    me = dist.get_rank()
    mine = None
    for row in grid.tolist():
        row = sorted(row)   # a group's ranks in order, as it gathers them
        key = (id(dist.group.WORLD), tuple(row))
        if key not in _GROUPS:
            _GROUPS[key] = (None if len(row) == dist.get_world_size()
                            else dist.new_group(row))
        if me in row:
            mine = (_GROUPS[key], len(row), row.index(me))
    if mine is None:
        raise ValueError(f"rank {me} is not in the mesh {mesh}")
    return mine
