"""Parameter exchange with the JAX package.

``pydens_tpu`` keeps a model's parameters in the tree
``{'net': {'fc1': {'w', 'b'}, ...}, 'log_scale', 'variables': {...}}``
(layer names from ``pydens_tpu/models/layout.py``: dense ``fc{i}``,
LayerNorm ``ln{i}`` ``{'g', 'b'}``, slopes ``aa{i}`` ``{'a'}``, the
modified MLP's ``fcu``/``fcw``, branch layers ``br{i}_...``).  Every leaf
has the same name, shape and storage layout here, so the conversion is
leaf by leaf.
"""

import numpy as np
import torch

__all__ = ["params_from_jax", "module_params_from_flax"]


def params_from_jax(tree, device=None, dtype=torch.float32):
    """Convert a JAX parameter tree whose leaves are numpy arrays (e.g.
    ``jax.tree.map(np.asarray, solver.model.params)``) to the same tree of
    torch tensors, ready for ``Model.load_params``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32), dtype=dtype,
                           device=device)


def module_params_from_flax(flax_params, module, device=None,
                            dtype=torch.float32):
    """A Flax module's parameters (``{'Dense_0': {'kernel', 'bias'}, ...}``,
    leaves as numpy arrays) as ``params['net']`` of
    :class:`~pydens_tpu_torch.models.module_adapter.ModuleModel` over the
    torch ``module``: the ``Dense_i`` in order onto the module's
    ``nn.Linear`` layers in order, each ``kernel`` ``(in, out)`` transposed
    to the ``weight`` ``(out, in)``."""
    from torch import nn
    from .models.module_adapter import _net_tree

    dense = sorted((k for k in flax_params if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    linears = [name for name, m in module.named_modules()
               if isinstance(m, nn.Linear)]
    if len(dense) != len(linears):
        raise ValueError(f"{len(dense)} Dense layers for {len(linears)} "
                         "nn.Linear layers")
    values = {}
    for flax_name, name in zip(dense, linears):
        layer = flax_params[flax_name]
        values[f"{name}.weight"] = np.asarray(layer["kernel"]).T
        values[f"{name}.bias"] = np.asarray(layer["bias"])
    tree = {}
    for key, sub in _net_tree(module).items():
        if isinstance(sub, dict):
            tree[key] = {p: params_from_jax(values[f"{key}.{p}"], device,
                                            dtype) for p in sub}
        else:
            tree[key] = params_from_jax(values[key], device, dtype)
    return tree
