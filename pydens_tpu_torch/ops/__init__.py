"""Compute-path ops: tokens (D/V), symbolic math, and the fused kernels
(``fused_taylor``, ``fused_mlp``) with their plain PyTorch versions."""

from .tokens import Expr, D, V, variable_scope, as_array, lift, EvalContext
from . import math

__all__ = ["Expr", "D", "V", "variable_scope", "as_array", "lift",
           "EvalContext", "math"]
