"""The model families whose ``Solver.export(with_grad=True)`` runs the
model on jets (``pydens_tpu_torch/models/jets.py``): ``name: (equation,
options)``, each a function of the package, at a width and depth.
tests/export_grad_cases.py holds the two packages' artifacts to each other
at 8 wide; chip_smoke.py serves the port's on the card at 64 wide.  This
module imports no jax: the two things that differ by package (the module
family's model, the bfloat16 family's dtype) are looked up in
:data:`SPECIFIC`, where tests/export_grad_cases.py adds ``pydens_tpu``'s."""

import numpy as np
import torch
from torch import nn

import pydens_tpu_torch as tpdt


def _heat(pdt):
    def heat(f, x, t):
        return pdt.D(f, t) - pdt.D(pdt.D(f, x), x)
    return heat


def _wave(pdt):
    def wave(f, x, t):
        return pdt.D(pdt.D(f, t), t) - pdt.D(pdt.D(f, x), x)
    return wave


def _poisson(pdt):
    def poisson(f, x, y):
        return pdt.D(pdt.D(f, x), x) + pdt.D(pdt.D(f, y), y) - 1.0
    return poisson


def _ic(pdt):
    return lambda x: pdt.sin(np.pi * x)


def _wrapping_ic(pdt):
    # Continues across the periodic wrap of x.
    return lambda x: pdt.sin(2 * np.pi * x)


def torch_net(width, depth):
    """``2 -> width`` tanh, ``depth`` times, ``-> 1``."""
    layers, n = [], 2
    for _ in range(depth):
        layers += [nn.Linear(n, width), nn.Tanh()]
        n = width
    return nn.Sequential(*layers, nn.Linear(n, 1))


# package: {"module": (width, depth) -> the module family's model,
#           "bfloat16": the bfloat16 family's dtype}
SPECIFIC = {tpdt: dict(
    module=lambda width, depth: tpdt.module_model(torch_net(width, depth)),
    bfloat16=torch.bfloat16)}


def families(width=8, depth=2, members=2):
    """``name: (equation, options)``, both functions of the package: the
    periodic, Fourier-feature, modified, LAAF, branched and LayerNorm
    chains, callable IC, BC and second IC, a module model, a separable
    model, an ensemble of ``members`` and a bfloat16 chain, each hidden
    layer ``width`` wide, ``depth`` of them on a chain."""
    w = width
    chain = dict(layout=" ".join(["fa"] * depth + ["f"]),
                 features=[w] * depth + [1], activation="Tanh")
    return {
        "periodic": (_heat, lambda pdt: dict(
            ndims=2, periodic=(0,), initial_condition=_wrapping_ic(pdt),
            **chain)),
        "fourier": (_heat, lambda pdt: dict(
            ndims=2, fourier_features=(w // 2, 2.0),
            initial_condition=_ic(pdt), **chain)),
        "modified": (_heat, lambda pdt: dict(
            ndims=2, initial_condition=_ic(pdt), boundary_condition=0.0,
            arch="modified", features=[w] * 3 + [1], activation="Tanh")),
        "laaf": (_poisson, lambda pdt: dict(
            ndims=2, boundary_condition=1.0, adaptive_activation=10.0,
            **chain)),
        "branches": (_heat, lambda pdt: dict(
            ndims=2, initial_condition=0.0, layout="fa B fa * B f . f",
            features=[w, w, w // 2, 1], activation="Sigmoid",
            branches=[dict(layout="fa", features=[w]),
                      dict(layout="f", features=[w // 4])])),
        "layernorm": (_heat, lambda pdt: dict(
            ndims=2, initial_condition=_ic(pdt),
            layout=" ".join(["fan"] + ["fa"] * (depth - 1) + ["f"]),
            features=[w] * depth + [1], activation="Tanh")),
        "callable_ic": (_heat, lambda pdt: dict(
            ndims=2, initial_condition=_ic(pdt), **chain)),
        "callable_bc": (_poisson, lambda pdt: dict(
            ndims=2, boundary_condition=lambda x, y: pdt.sin(np.pi * x) * y
            + 0.25, **chain)),
        "second_ic": (_wave, lambda pdt: dict(
            ndims=2, initial_condition=_ic(pdt),
            initial_condition_t=lambda x: 0.5 * pdt.cos(np.pi * x),
            boundary_condition=0.0, **chain)),
        "module": (_heat, lambda pdt: dict(
            ndims=2, initial_condition=0.0,
            model=SPECIFIC[pdt]["module"](w, depth))),
        "separable": (_poisson, lambda pdt: dict(
            ndims=2, boundary_condition=0.0, model=pdt.SeparableModel,
            layout=" ".join(["fa"] * depth + ["f"]),
            features=[w] * depth + [w // 2], activation="Tanh")),
        "ensemble": (_heat, lambda pdt: dict(
            ndims=2, periodic=(0,), initial_condition=_wrapping_ic(pdt),
            n_models=members, **chain)),
        "bfloat16": (_heat, lambda pdt: dict(
            ndims=2, initial_condition=_ic(pdt),
            dtype=SPECIFIC[pdt]["bfloat16"], **chain)),
    }
