"""Adapter: use any ``torch.nn.Module`` as the network body of a PINN model.

Counterpart of ``pydens_tpu/models/flax_adapter.py`` (``FlaxModel`` /
``flax_model``).  The reference's custom-architecture path is subclassing
``TorchModel`` with ``torch.nn`` layers; this adapter wraps a module behind
the :class:`~pydens_tpu_torch.models.base.Model` interface (ansatz,
freeze/unfreeze, ensembles, checkpoints, Solver integration) without any
change to the training machinery::

    from torch import nn

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.hidden = nn.Linear(2, 32)
            self.out = nn.Linear(32, 1)

        def forward(self, x):
            return self.out(torch.tanh(self.hidden(x)))

    solver = Solver(pde, ndims=2, boundary_condition=0,
                    model=module_model(Net()))

The module maps ``(N, ndims + nparams) -> (N, n_out)``.  Its parameters
live under ``params['net']``, keyed by the module's top-level children
(``named_children``) and below those by their parameter names, so
``freeze_trainable(layers=['hidden'])`` freezes a child; a parameter held
by the module itself sits at the top level under its own name.

Initial parameters are a function of the Solver's ``seed`` alone: for
each member, a seed is drawn from the Solver's init generator, and every
submodule's ``reset_parameters()`` runs under ``torch.random.fork_rng``
seeded with it, on a CPU copy of the module (so the process's global RNG
is untouched, and the card and the CPU start alike).

The module model has no Taylor plan: derivatives take nested ``D``, as for
``FlaxModel`` (``Model.supports_taylor``); ``Solver.export(with_grad=True)``
runs the module on jets (``models/jets.py``).  Buffers (BatchNorm
statistics and the like) are not supported.
"""

from __future__ import annotations

import copy

import torch

from .base import Model
from .jets import Jet

__all__ = ["ModuleModel", "module_model"]


def _net_tree(module):
    """``{child: {param name: parameter}}`` (a parameter of the module
    itself at the top level)."""
    tree = {name: p for name, p in module.named_parameters(recurse=False)}
    for child, sub in module.named_children():
        params = dict(sub.named_parameters())
        if params:
            tree[child] = params
    return tree


def _flat_names(tree):
    """The tree's leaves under ``functional_call``'s dotted names."""
    flat = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            flat.update({f"{key}.{name}": t for name, t in sub.items()})
        else:
            flat[key] = sub
    return flat


class ModuleModel(Model):
    """A :class:`Model` whose network body is a ``torch.nn.Module``."""

    def __init__(self, module, **kwargs):
        super().__init__(**kwargs)
        buffers = [name for name, _ in module.named_buffers()]
        if buffers:
            raise ValueError(
                "torch modules with non-parameter collections (buffers: "
                f"{sorted(buffers)}) are not supported")
        # The init copy stays on the CPU in float32; the live one holds the
        # parameters on the model's device.
        self._template = [copy.deepcopy(module).float().cpu()]
        self.module = copy.deepcopy(module).to(device=self.device,
                                               dtype=self.dtype)

    def reset_parameters(self, generator):
        template = self._template[0]
        live = _flat_names(self.network_params())
        for k in range(self.n_models):
            seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                for sub in template.modules():
                    if hasattr(sub, "reset_parameters"):
                        sub.reset_parameters()
            with torch.no_grad():
                for name, p in template.named_parameters():
                    dst = live[name] if self.n_models == 1 else live[name][k]
                    dst.copy_(p)
        with torch.no_grad():
            self.log_scale.zero_()

    def network_params(self):
        return _net_tree(self.module)

    def network_apply(self, net_params, xs):
        """The module on ``xs``; an ensemble's members (leaves with a
        leading ``(K,)``) on shared ``(N, in)`` points or their own ``(K,
        N, in)`` ones, ``(K, N, out)``."""
        flat = _flat_names(net_params)

        def call(leaves, x):
            return torch.func.functional_call(self.module, leaves, (x,))

        if self.n_models == 1:
            return call(flat, xs)
        if isinstance(xs, Jet):
            # vmap takes no jet (an exported derivative): member by member.
            return torch.stack([
                call({name: t[k] for name, t in flat.items()},
                     xs if xs.dim() == 2 else xs[k])
                for k in range(self.n_models)])
        return torch.func.vmap(call, in_dims=(0, 0 if xs.dim() == 3
                                              else None))(flat, xs)


def module_model(module):
    """Build a ``Solver``-compatible model class from a module instance
    (the ``model=`` argument expects a class).  Each Solver trains its own
    copy of the module."""

    class _Bound(ModuleModel):
        def __init__(self, **kwargs):
            super().__init__(module=module, **kwargs)

    _Bound.__name__ = f"ModuleModel({type(module).__name__})"
    return _Bound
