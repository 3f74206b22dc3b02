"""Symbolic (Expr-aware) math functions, counterpart of
``pydens_tpu/ops/math.py``: ``pdt.sin(np.pi * (x + y))`` stays
differentiable on coordinate symbols and falls through to torch on plain
tensors.  (``torch.sin`` on a symbol works as well, through
``Expr.__torch_function__``.)"""

import torch

from .tokens import lift

sin = lift(torch.sin)
cos = lift(torch.cos)
tan = lift(torch.tan)
arcsin = lift(torch.arcsin)
arccos = lift(torch.arccos)
arctan = lift(torch.arctan)
arctan2 = lift(torch.arctan2)
sinh = lift(torch.sinh)
cosh = lift(torch.cosh)
tanh = lift(torch.tanh)
exp = lift(torch.exp)
expm1 = lift(torch.expm1)
log = lift(torch.log)
log1p = lift(torch.log1p)
log2 = lift(torch.log2)
log10 = lift(torch.log10)
sqrt = lift(torch.sqrt)
square = lift(torch.square)
power = lift(torch.pow)
abs = lift(torch.abs)  # pylint: disable=redefined-builtin
sign = lift(torch.sign)
maximum = lift(torch.maximum)
minimum = lift(torch.minimum)
where = lift(torch.where)
clip = lift(torch.clip)
sigmoid = lift(torch.sigmoid)
softplus = lift(torch.nn.functional.softplus)
erf = lift(torch.erf)

__all__ = [
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "arctan2",
    "sinh", "cosh", "tanh", "exp", "expm1", "log", "log1p", "log2", "log10",
    "sqrt", "square", "power", "abs", "sign", "maximum", "minimum", "where",
    "clip", "sigmoid", "softplus", "erf",
]
