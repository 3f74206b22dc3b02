"""PyDEns-TPU ported to PyTorch and CUDA: physics-informed training of
neural networks for ODEs and PDEs on an NVIDIA GPU.

A second package beside ``pydens_tpu`` (JAX, the reference it is held
against), with the same ``Solver`` / ``D`` / ``V`` surface.  It imports
``torch`` and never ``jax``.  The fused Taylor traversal that every planned
training step runs and the fused MLP forward behind ``predict`` are CUDA
kernels written for Hopper (``csrc/``), built with ``nvcc`` at first use;
on the CPU their plain PyTorch versions run instead.
"""

from .ops.tokens import D, V, Expr, lift
from .ops.fields import Field
from .ops.functional import grad, div, laplace, hessian_diag, dt, dn
from .ops.math import (sin, cos, tan, arcsin, arccos, arctan, arctan2, sinh,
                       cosh, tanh, exp, expm1, log, log1p, log2, log10, sqrt,
                       square, power, sign, maximum, minimum, where, clip,
                       sigmoid, softplus, erf)
from .models import (Model, ConvBlockModel, TorchModel, ModuleModel,
                     module_model, SeparableModel)
from .solver import Solver
from .samplers import (Sampler, NumpySampler, NS, ConstantSampler,
                       HistoSampler, ScipySampler, ProductSampler,
                       MixtureSampler, GeometrySampler, BoundarySampler,
                       HaltonSampler)
from .parallel import make_mesh
from .utils.grids import cart_prod, uniform_grid
from .utils.export import load_exported
from .interop import params_from_jax

__version__ = "0.5.0"

__all__ = [
    "Solver", "D", "V", "Field", "Expr", "lift",
    "grad", "div", "laplace", "hessian_diag", "dt", "dn",
    "cart_prod", "uniform_grid",
    "Model", "ConvBlockModel", "TorchModel", "ModuleModel", "module_model",
    "SeparableModel", "params_from_jax",
    "Sampler", "NumpySampler", "NS", "ConstantSampler", "HistoSampler",
    "ScipySampler", "ProductSampler", "MixtureSampler", "GeometrySampler",
    "BoundarySampler", "HaltonSampler",
    "make_mesh", "load_exported",
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "arctan2", "sinh",
    "cosh", "tanh", "exp", "expm1", "log", "log1p", "log2", "log10", "sqrt",
    "square", "power", "sign", "maximum", "minimum", "where", "clip",
    "sigmoid", "softplus", "erf",
]
