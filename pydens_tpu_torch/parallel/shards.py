"""What a ``Solver`` on a mesh needs of it: its data and member slices, and
the collectives of a training step (counterpart of ``_mesh_axes`` and the
sharding constraints of ``pydens_tpu/solver.py``).

Every rank draws the same full batch and keeps its contiguous slice over
the data axes (every axis but ``'models'``, jointly); with ``n_models > 1``
an axis named ``'models'`` shards the ensemble's members.  A step's loss
and flat gradient are each rank's estimate of the whole batch's, scaled by
its share and summed over the data ranks in one all-reduce, so every rank
holds the same parameters after the update.  On the card the collectives
are NCCL's and are captured in the step's CUDA graph; on the CPU gloo's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import axis_group

__all__ = ["Shards", "mesh_axes"]


def mesh_axes(mesh, n_models):
    """``(data_axes, model_axis)`` of a mesh: an axis named ``'models'``
    shards ensemble members (when ``n_models > 1``); every other axis
    jointly shards the collocation batch (``_mesh_axes`` of
    ``pydens_tpu/solver.py``)."""
    names = list(mesh.mesh_dim_names)
    model_axis = "models" if ("models" in names and n_models > 1) else None
    data_axes = tuple(a for a in names if a != "models") or None
    return data_axes, model_axis


class Shards:
    """This rank's place on ``mesh`` for a solver of ``n_models`` members
    on ``device``: ``n_data`` ranks share a batch (this one is
    ``data_index``), ``n_member_ranks`` share the members (this one holds
    ``members``, a slice of ``k_local``).  ``Shards.collectives`` counts the
    collectives issued (under a CUDA graph: at capture, not per replay)."""

    collectives = 0

    def __init__(self, mesh, n_models, device):
        if mesh.device_type != device.type:
            raise ValueError(
                f"the mesh's ranks are on '{mesh.device_type}' but the "
                f"solver is on '{device.type}'; make the mesh with "
                f"make_mesh(device='{device.type}')")
        if mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                             f"{mesh}: every rank of a Solver's mesh trains")
        self.mesh = mesh
        self.data_axes, self.model_axis = mesh_axes(mesh, n_models)
        self.data_group, self.n_data, self.data_index = (
            axis_group(mesh, self.data_axes) if self.data_axes
            else (None, 1, 0))
        self.member_group, self.n_member_ranks, index = (
            axis_group(mesh, (self.model_axis,)) if self.model_axis
            else (None, 1, 0))
        self.n_models = n_models
        self.k_local = n_models // self.n_member_ranks
        self.members = slice(index * self.k_local, (index + 1) * self.k_local)
        self.writer = dist.get_rank() == int(mesh.mesh.min())
        self._nccl = mesh.device_type == "cuda"

    # -- slices -------------------------------------------------------------
    def rows(self, n):
        """This rank's share of ``n`` rows."""
        return n // self.n_data

    def shard(self, t, axis=0):
        """This rank's contiguous slice of ``t`` along ``axis``."""
        step = t.shape[axis] // self.n_data
        return t.narrow(axis, self.data_index * step, step)

    def local_members(self, t, axis=0):
        """This rank's members of a full ``(K, ...)`` tensor (a single
        model's tensor as it is)."""
        if self.model_axis is None:
            return t
        t = t.narrow(axis, self.members.start, self.k_local)
        return t.squeeze(axis) if self.k_local == 1 else t

    # -- collectives --------------------------------------------------------
    def sum(self, t):
        """``t`` summed over the data ranks, in place."""
        Shards.collectives += 1
        dist.all_reduce(t, group=self.data_group)
        return t

    def share_sum(self, *parts):
        """Each of ``parts`` (tensors; a rank's estimate of a whole-batch
        quantity) scaled by the rank's share and summed over the data
        ranks, in one all-reduce."""
        return self._sum_parts(parts, 1.0 / self.n_data)

    def sum_parts(self, *parts):
        """Each of ``parts`` summed over the data ranks, in one
        all-reduce."""
        return self._sum_parts(parts, 1.0)

    def _sum_parts(self, parts, scale):
        buf = torch.cat([p.reshape(-1) for p in parts])
        if scale != 1.0:
            buf = buf * scale
        self.sum(buf)
        out, at = [], 0
        for p in parts:
            out.append(buf[at:at + p.numel()].view(p.shape))
            at += p.numel()
        return out

    def max(self, t):
        """``t`` maximized over the data ranks, in place."""
        Shards.collectives += 1
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.data_group)
        return t

    def member_sum(self, t):
        """``t`` summed over the member ranks (a copy; ``t`` without a
        models axis)."""
        if self.model_axis is None:
            return t
        t = t.clone()
        Shards.collectives += 1
        dist.all_reduce(t, group=self.member_group)
        return t

    def _gather(self, t, group, size):
        if size == 1:
            return t.unsqueeze(0)
        Shards.collectives += 1
        t = t.contiguous()
        if self._nccl:
            out = t.new_empty((size,) + tuple(t.shape))
            dist.all_gather_into_tensor(out, t, group=group)
            return out
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        return torch.stack(parts)

    def gather_rows(self, fn, rows):
        """``fn`` of every row of ``rows`` (the same on every data rank):
        each rank evaluates its slice (the rows padded to a multiple of
        the data ranks with the last one) and the results are gathered, so
        every rank holds them all."""
        n = rows.shape[0]
        per = -(-n // self.n_data)
        pad = per * self.n_data - n
        if pad:
            rows = torch.cat([rows, rows[-1:].expand(pad, rows.shape[1])])
        mine = fn(rows.narrow(0, self.data_index * per, per))
        out = self._gather(mine, self.data_group, self.n_data)
        return out.reshape((-1,) + tuple(mine.shape[1:]))[:n]

    def gather_members(self, t, axis=0):
        """Every rank's members of ``t`` (``(k_local, ...)`` on ``axis``,
        a single model's without it) as the full ``(K, ...)``."""
        if self.model_axis is None:
            return t
        if self.k_local == 1:
            t = t.unsqueeze(axis)
        t = t.movedim(axis, 0)
        out = self._gather(t, self.member_group, self.n_member_ranks)
        return out.reshape((-1,) + tuple(t.shape[1:])).movedim(0, axis)

    def barrier(self):
        dist.barrier()
