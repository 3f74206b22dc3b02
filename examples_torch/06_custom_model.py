"""Custom architectures on pydens_tpu_torch: subclass `Model` with its
network body — ``reset_parameters`` (draw the weights from the Solver's
generator), ``network_params`` (the layers by name) and ``network_apply``
(a pure function of those parameters) — the equivalent of subclassing the
reference's `TorchModel`.  The port of examples/06; the body has no Taylor
plan, so ``D`` takes nested autograd.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/06_custom_model.py [--cpu]
"""

import sys

import numpy as np
import torch
from torch import nn

from pydens_tpu_torch import Model, Solver, D


class ResidualMLP(Model):
    """Three hidden tanh layers with a residual connection."""

    WIDTH = 24

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        w = self.WIDTH
        shapes = {"fc1": (self.total, w), "fc2": (w, w), "fc3": (w, w),
                  "fc4": (w, 1)}
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({
                "w": nn.Parameter(torch.empty((din, dout),
                                              device=self.device)),
                "b": nn.Parameter(torch.empty((dout,), device=self.device))})
            for name, (din, dout) in shapes.items()})

    def reset_parameters(self, generator):
        with torch.no_grad():
            for layer in self.layers.values():
                bound = 1.0 / np.sqrt(layer["w"].shape[0])
                for p in (layer["w"], layer["b"]):
                    p.copy_(torch.rand(p.shape, generator=generator)
                            * (2 * bound) - bound)

    def network_params(self):
        return {name: {"w": layer["w"], "b": layer["b"]}
                for name, layer in self.layers.items()}

    def network_apply(self, net, xs):
        h = torch.tanh(xs @ net["fc1"]["w"] + net["fc1"]["b"])
        skip = h
        h = torch.tanh(h @ net["fc2"]["w"] + net["fc2"]["b"])
        h = torch.tanh(h @ net["fc3"]["w"] + net["fc3"]["b"] + skip)
        return h @ net["fc4"]["w"] + net["fc4"]["b"]


def ode(f, x):
    return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)


def main(device=None):
    solver = Solver(ode, ndims=1, initial_condition=.5, model=ResidualMLP,
                    seed=0, device=device)
    solver.fit(niters=600, batch_size=400, lr=0.01)
    xs = np.linspace(0, 1, 100)
    err = float(np.max(np.abs(solver.predict(xs).ravel()
                              - (np.sin(2 * np.pi * xs) + .5))))
    print(f"custom-model max error: {err:.4f}")
    # freeze works on custom layer names too
    solver.model.freeze_trainable(layers=["fc1"])
    solver.fit(niters=50, batch_size=400, lr=0.01)
    assert err < 0.05
    return solver, {"err": err}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
