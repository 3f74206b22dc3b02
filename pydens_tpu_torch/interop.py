"""Parameter exchange with the JAX package.

``pydens_tpu`` keeps a model's parameters in the tree
``{'net': {'fc1': {'w', 'b'}, ...}, 'log_scale', 'variables': {...}}``
(layer names from ``pydens_tpu/models/layout.py``).  Dense weights have the
same storage layout here, so the conversion is leaf by leaf.
"""

import numpy as np
import torch

__all__ = ["params_from_jax"]


def params_from_jax(tree, device=None, dtype=torch.float32):
    """Convert a JAX parameter tree whose leaves are numpy arrays (e.g.
    ``jax.tree.map(np.asarray, solver.model.params)``) to the same tree of
    torch tensors, ready for ``Model.load_params``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32), dtype=dtype,
                           device=device)
