"""Parallelism: device meshes over ``torch.distributed`` ranks and
multi-process coordination (counterpart of ``pydens_tpu/parallel``)."""

from .mesh import make_mesh
from . import distributed

__all__ = ["make_mesh", "distributed"]
