"""Multilinear Taylor coefficients ("jets") for the ansatz composition.

``Model.full_taps`` needs, for a derivative multi-index ``p = (p_0, ...,
p_{m-1})``, the mixed partial ``d^m / ds_0 ... ds_{m-1}`` at 0 of
``anzatc(net(s), xs + sum_i s_i e_{p_i})``.  Every quantity of that
composition is held here as a :class:`Jet`: its coefficient ``c[S] =
d^S q (0)`` for each subset ``S`` of the ``m`` scalars (a bitmask), which
is all a mixed partial in distinct scalars needs.  Sums add coefficients,
products take the Leibniz rule over subsets, a function of one variable
the Faa di Bruno rule over set partitions.  It is forward mode written
out: every coefficient is computed in program order in the forward pass,
so no value depends on the order in which the autograd engine runs nodes,
and plain tensor ops take the place of ``torch.func.jvp``'s per-op
transform.  Coefficients known to be zero are ``None``; coefficients may
be Python floats.

A :class:`Jet` is also runnable model input: ``torch`` functions and
``Tensor`` methods called on one dispatch through ``__torch_function__``
(numpy ufuncs through ``__array_ufunc__``) to a table of operators, each
with its rule written out in plain torch ops: linear operators act on each
coefficient, products and quotients take the Leibniz rule, a function of
one variable its derivative as a function of the jet (so every rule holds
at any order).  ``Solver.export(with_grad=True)`` runs a model's plain
forward on jets this way, and ``torch.export`` traces the ATen operators
the rules emit.  An operator outside the table raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Jet", "sigmoid"]

_SUBSETS = {}
_PARTITIONS = {}
_SIGMOID_TERMS = [{}, {(1, 0): 1}]   # sigma^(k): {(a, b): coefficient}


def _submasks(mask):
    """Every ``T`` with ``T & ~mask == 0``, ``0`` and ``mask`` included."""
    if mask not in _SUBSETS:
        out, t = [], mask
        while True:
            out.append(t)
            if t == 0:
                break
            t = (t - 1) & mask
        _SUBSETS[mask] = out
    return _SUBSETS[mask]


def _partitions(mask):
    """The set partitions of the bits of ``mask``, each a tuple of block
    masks (the block holding the lowest bit first)."""
    if mask not in _PARTITIONS:
        if mask == 0:
            parts = [()]
        else:
            low = mask & -mask
            rest = mask ^ low
            parts = []
            for sub in _submasks(rest):
                for tail in _partitions(rest ^ sub):
                    parts.append((low | sub,) + tail)
        _PARTITIONS[mask] = parts
    return _PARTITIONS[mask]


def _add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _mul(a, b):
    if a is None or b is None:
        return None
    return a * b


class Jet:
    """A quantity's coefficients ``c[S]`` over the subsets of ``m`` scalars
    (``len(c) == 2 ** m``).  Mixes with tensors and numbers as constants."""

    __slots__ = ("c",)

    def __init__(self, c):
        self.c = list(c)

    @classmethod
    def constant(cls, value, m):
        return cls([value] + [None] * ((1 << m) - 1))

    @classmethod
    def coordinate(cls, value, column, p):
        """Coordinate ``column`` shifted by every scalar ``s_i`` with
        ``p[i] == column``: slope 1 in those."""
        c = cls.constant(value, len(p))
        for i, col in enumerate(p):
            if col == column:
                c.c[1 << i] = 1.0
        return c

    @property
    def top(self):
        """The mixed partial in all ``m`` scalars."""
        return self.c[-1]

    def _lift(self, other):
        if isinstance(other, Jet):
            return other
        return Jet.constant(other, len(self.c).bit_length() - 1)

    def __add__(self, other):
        other = self._lift(other)
        return Jet([_add(a, b) for a, b in zip(self.c, other.c)])

    __radd__ = __add__

    def __neg__(self):
        return Jet([None if a is None else -a for a in self.c])

    def __sub__(self, other):
        return self + (-self._lift(other))

    def __rsub__(self, other):
        return self._lift(other) + (-self)

    def __mul__(self, other):
        if not isinstance(other, Jet):
            return Jet([_mul(a, other) for a in self.c])
        out = []
        for mask in range(len(self.c)):
            acc = None
            for t in _submasks(mask):
                acc = _add(acc, _mul(self.c[t], other.c[mask ^ t]))
            out.append(acc)
        return Jet(out)

    __rmul__ = __mul__

    def __truediv__(self, other):
        """Division by a constant (a tensor or a number) or by a jet."""
        if isinstance(other, Jet):
            return _quotient(self, other)
        return Jet([None if a is None else a / other for a in self.c])

    def __rtruediv__(self, other):
        return _quotient(other, self)

    @property
    def order(self):
        """The number ``m`` of scalars."""
        return len(self.c).bit_length() - 1

    # -- runnable model input: the operator table below --------------------
    def __pow__(self, other):
        return torch.pow(self, other)

    def __rpow__(self, other):
        return torch.pow(other, self)

    def __matmul__(self, other):
        return torch.matmul(self, other)

    def __rmatmul__(self, other):
        return torch.matmul(other, self)

    def __getitem__(self, index):
        return _each(torch.Tensor.__getitem__, (self, index), {})

    def __pos__(self):
        return self

    def __abs__(self):
        return torch.abs(self)

    def __len__(self):
        return len(self.c[0])

    # Comparisons read the value: they are not differentiable.
    def __lt__(self, other):
        return torch.lt(self, other)

    def __le__(self, other):
        return torch.le(self, other)

    def __gt__(self, other):
        return torch.gt(self, other)

    def __ge__(self, other):
        return torch.ge(self, other)

    def __eq__(self, other):
        return torch.eq(self, other)

    def __ne__(self, other):
        return torch.ne(self, other)

    __hash__ = object.__hash__

    def __getattr__(self, name):
        """``shape``, ``dtype``, ``device`` and ``ndim`` from the value;
        ``Tensor`` methods (``reshape``, ``dim``, ``new_zeros``, ...)
        through the operator table."""
        if name.startswith("__") or name == "c":
            raise AttributeError(name)
        if name in _VALUE_ATTRS:
            return getattr(self.c[0], name)
        if name == "T":
            return _each(lambda t: t.T, (self,), {})
        method = getattr(torch.Tensor, name, None)
        if not callable(method):
            raise AttributeError(f"'Jet' object has no attribute {name!r}")
        return lambda *args, **kwargs: Jet.__torch_function__(
            method, (Jet,), (self,) + args, kwargs)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        rule = _RULES.get(func)
        if rule is None:
            raise _no_rule(torch.overrides.resolve_name(func) or repr(func))
        return rule(func, args, kwargs or {})

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        fn = _UFUNCS.get(ufunc.__name__)
        if method != "__call__" or kwargs or fn is None:
            raise _no_rule(f"numpy.{ufunc.__name__}.{method}")
        ref = next(a for a in inputs if isinstance(a, Jet)).c[0]
        return fn(*[torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
                    if isinstance(a, np.ndarray) else a for a in inputs])

    def apply(self, derivs):
        """``f(self)`` from ``derivs = [f(v), f'(v), f''(v), ...]`` at the
        value ``v = c[0]`` (as many as ``m + 1``): the Faa di Bruno rule
        over the set partitions of each subset."""
        out = [derivs[0]]
        for mask in range(1, len(self.c)):
            acc = None
            for part in _partitions(mask):
                term = derivs[len(part)]
                for block in part:
                    term = _mul(term, self.c[block])
                acc = _add(acc, term)
            out.append(acc)
        return Jet(out)


def _sigmoid_terms(k):
    """``sigma^(k)`` (``k >= 1``) as ``{(a, b): coefficient}`` of the
    monomials ``d1^a u^b``, with ``d1 = sigma (1 - sigma)`` and ``u = 1 -
    2 sigma`` (``d1' = d1 u``, ``u' = -2 d1``): products of factors that
    keep their relative precision where sigma nears 0 or 1, as the nested
    derivatives of ``sigma' = sigma (1 - sigma)`` do, where a polynomial
    in sigma would cancel."""
    while len(_SIGMOID_TERMS) <= k:
        new = {}
        for (a, b), coef in _SIGMOID_TERMS[-1].items():
            new[(a, b + 1)] = new.get((a, b + 1), 0) + a * coef
            if b:
                new[(a + 1, b - 1)] = new.get((a + 1, b - 1), 0) - 2 * b * coef
        _SIGMOID_TERMS.append({key: c for key, c in new.items() if c})
    return _SIGMOID_TERMS[k]


def sigmoid(x):
    """``torch.sigmoid`` of a tensor, or of a :class:`Jet` by its
    derivatives in closed form (:func:`_sigmoid_terms`)."""
    if not isinstance(x, Jet):
        return torch.sigmoid(x)
    order = len(x.c).bit_length() - 1
    s = torch.sigmoid(x.c[0])
    d1 = s * (1.0 - s)
    u = 1.0 - 2.0 * s
    powers = {}

    def power(t, name, e):
        if (name, e) not in powers:
            powers[(name, e)] = t if e == 1 else power(t, name, e - 1) * t
        return powers[(name, e)]
    derivs = [s]
    for k in range(1, order + 1):
        acc = None
        for (a, b), coef in sorted(_sigmoid_terms(k).items()):
            term = power(d1, "d1", a)
            if b:
                term = term * power(u, "u", b)
            acc = _add(acc, term if coef == 1 else float(coef) * term)
        derivs.append(acc)
    return x.apply(derivs)


# -- the operator table -------------------------------------------------------
_VALUE_ATTRS = frozenset(("shape", "dtype", "device", "ndim"))
_RULES = {}


def _no_rule(name):
    """The error for an operator outside the table, named."""
    return NotImplementedError(
        f"{name} has no forward-mode rule for jets (the operator table of "
        "pydens_tpu_torch/models/jets.py)")


def _order_of(args):
    """The number of scalars of the jets among ``args`` (nested lists
    included)."""
    for a in args:
        if isinstance(a, Jet):
            return a.order
        if isinstance(a, (list, tuple)):
            m = _order_of(a)
            if m is not None:
                return m
    return None


def _coefs(x, m):
    """``x``'s coefficients over ``m`` scalars: a jet's, or a constant's
    (its value, then zeros)."""
    if isinstance(x, Jet):
        return x.c
    return [x] + [None] * ((1 << m) - 1)


def _dense(coef, value):
    """A coefficient as a tensor of the value's shape (a number fills it,
    a broadcast coefficient expands), for operators that move elements
    between positions; None stays None."""
    if coef is None or isinstance(value, (int, float)):
        return coef
    if torch.is_tensor(coef):
        return coef if coef.shape == value.shape else coef.expand_as(value)
    return torch.full_like(value, coef)


def _value(x):
    if isinstance(x, Jet):
        return x.c[0]
    if isinstance(x, (list, tuple)):
        return type(x)(_value(a) for a in x)
    return x


def _each(func, args, kwargs):
    """An operator linear in its first argument, the jet, with every other
    argument fixed (a shape, an index, a dim): applied to each
    coefficient."""
    x, rest = args[0], args[1:]
    value = x.c[0]
    return Jet([func(value, *rest, **kwargs)]
               + [None if a is None else func(_dense(a, value), *rest,
                                              **kwargs)
                  for a in x.c[1:]])


def _sequence(func, args, kwargs):
    """An operator linear in a sequence of tensors (``cat``, ``stack``):
    a constant member's coefficients are zeros."""
    items, rest = args[0], args[1:]
    m = _order_of(items)
    cols = [_coefs(a, m) for a in items]
    values = [c[0] for c in cols]
    out = [func(values, *rest, **kwargs)]
    for k in range(1, 1 << m):
        if all(c[k] is None for c in cols):
            out.append(None)
            continue
        out.append(func([torch.zeros_like(v) if c[k] is None
                         else _dense(c[k], v)
                         for c, v in zip(cols, values)], *rest, **kwargs))
    return Jet(out)


def _on_value(func, args, kwargs):
    """Operators whose result is no jet: comparisons, shapes, constants
    shaped like the input (``zeros_like``, ``new_ones``)."""
    return func(*_value(args), **{k: _value(v) for k, v in kwargs.items()})


def _terms(cols, mask, j=0):
    """Every choice of one coefficient a factor, over disjoint submasks of
    ``mask`` that cover it, with no zero (None) among them."""
    if j == len(cols) - 1:
        if cols[j][mask] is not None:
            yield (cols[j][mask],)
        return
    for t in _submasks(mask):
        if cols[j][t] is not None:
            for rest in _terms(cols, mask ^ t, j + 1):
                yield (cols[j][t],) + rest


def _multilinear(args, full, part):
    """A product of several factors (``matmul``, ``linear``, ``einsum``):
    the general Leibniz rule.  ``full`` gives the value from the factors'
    values (with a bias, where the operator adds one), ``part`` every
    other term."""
    m = _order_of(args)
    cols = [[c[0]] + [_dense(t, c[0]) for t in c[1:]]
            for c in (_coefs(a, m) for a in args)]
    out = [full(*[c[0] for c in cols])]
    for mask in range(1, 1 << m):
        acc = None
        for factors in _terms(cols, mask):
            acc = _add(acc, part(*factors))
        out.append(acc)
    return Jet(out)


def _quotient(a, b):
    """``a / b`` for jets or constants: the value divided as it is, each
    higher coefficient from ``q b = a`` by the Leibniz rule."""
    m = _order_of((a, b))
    ac, bc = _coefs(a, m), _coefs(b, m)
    out = [ac[0] / bc[0]]
    for mask in range(1, 1 << m):
        num = ac[mask]
        for t in _submasks(mask)[1:]:        # every proper submask of mask
            term = _mul(out[t], bc[mask ^ t])
            if term is not None:
                num = -term if num is None else num - term
        out.append(None if num is None else num / bc[0])
    return Jet(out)


def _chain(fn, partials, args):
    """``fn(*args)`` for jets and constants, from its partial derivatives
    as functions of the arguments and the value (themselves run on jets).
    Coefficients free of the first scalar are ``fn`` of the arguments
    restricted to the other scalars; each with it is ``sum_T d^T f_j *
    c_j[S \\ T]`` over the subsets ``T`` of the others, ``f_j`` a partial.
    Every rule below is so correct at any order."""
    m = _order_of(args)
    if m == 0:
        return Jet([fn(*[_coefs(a, 0)[0] for a in args])])
    cols = [_coefs(a, m) for a in args]
    low = [c[0] if m == 1 else Jet(c[0::2]) if isinstance(a, Jet) else a
           for a, c in zip(args, cols)]
    y = fn(*low)
    gs = partials(*low, y)
    yc, gcs = _coefs(y, m - 1), [_coefs(g, m - 1) for g in gs]
    out = [None] * (1 << m)
    for mask in range(1 << m):
        if not mask & 1:
            out[mask] = yc[mask >> 1]
            continue
        acc = None
        for c, gc in zip(cols, gcs):
            for t in _submasks(mask ^ 1):
                acc = _add(acc, _mul(gc[t >> 1], c[mask ^ t]))
        out[mask] = acc
    return Jet(out)


def _unary(deriv):
    """A rule for a function of one jet (the first argument; the others and
    the keywords fixed), with ``deriv(x, y, ...)`` its derivative at ``x``
    where ``y`` is the function's value there."""
    def rule(func, args, kwargs):
        rest = args[1:]
        return _chain(lambda x: func(x, *rest, **kwargs),
                      lambda x, y: [deriv(x, y, *rest, **kwargs)],
                      (args[0],))
    return rule


def _register(rule, *names):
    """``rule`` under ``torch.<name>``, ``torch.Tensor.<name>`` and
    ``torch.nn.functional.<name>``, where each exists."""
    for name in names:
        for owner in (torch, torch.Tensor, F):
            func = getattr(owner, name, None)
            if func is not None:
                _RULES[func] = rule


def _arith(op):
    def rule(func, args, kwargs):
        a, b = args[0], args[1]
        if "alpha" in kwargs:
            b = b * kwargs["alpha"]
        a, b = (a, b) if isinstance(a, Jet) else (Jet.constant(a, b.order), b)
        return op(a, b)
    return rule


def _mul_rule(func, args, kwargs):
    a, b = args[0], args[1]
    return a * b if isinstance(a, Jet) else b * a


def _div_rule(func, args, kwargs):
    if kwargs.get("rounding_mode") is not None:
        raise _no_rule(f"div(rounding_mode={kwargs['rounding_mode']!r})")
    return _quotient(args[0], args[1])


def _pow_rule(func, args, kwargs):
    base, expo = args[0], args[1]
    if not isinstance(expo, Jet):
        return _chain(lambda x: torch.pow(x, expo),
                      lambda x, y: [expo * torch.pow(x, expo - 1)], (base,))
    if not isinstance(base, Jet):
        return _chain(lambda e: torch.pow(base, e),
                      lambda e, y: [y * math.log(base) if isinstance(
                          base, (int, float)) else y * torch.log(base)],
                      (expo,))
    return _chain(torch.pow, lambda x, e, y: [e * torch.pow(x, e - 1),
                                              y * torch.log(x)],
                  (base, expo))


def _matmul_rule(op):
    def rule(func, args, kwargs):
        return _multilinear(args[:2], op, op)
    return rule


def _linear_rule(func, args, kwargs):
    """``F.linear`` of a jet input or weight; the bias, a constant, lands
    on the value only."""
    w = args[1] if len(args) > 1 else kwargs["weight"]
    bias = args[2] if len(args) > 2 else kwargs.get("bias")
    return _multilinear((args[0], w), lambda a, b: F.linear(a, b, bias),
                        F.linear)


def _addmm_rule(func, args, kwargs):
    """``torch.addmm`` of jet factors; the added input, a constant, lands
    on the value only."""
    inp, m1, m2 = args[:3]
    beta, alpha = kwargs.get("beta", 1), kwargs.get("alpha", 1)
    return _multilinear(
        (m1, m2), lambda a, b: torch.addmm(inp, a, b, beta=beta,
                                           alpha=alpha),
        lambda a, b: alpha * torch.mm(a, b))


def _einsum_rule(func, args, kwargs):
    eq, ops = args[0], args[1:]
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = tuple(ops[0])

    def op(*xs):
        return torch.einsum(eq, *xs)
    return _multilinear(ops, op, op)


def _where_rule(func, args, kwargs):
    cond, a, b = _value(args[0]), args[1], args[2]
    m = _order_of((a, b))
    ac, bc = _coefs(a, m), _coefs(b, m)
    out = [torch.where(cond, ac[0], bc[0])]
    for k in range(1, 1 << m):
        if ac[k] is None and bc[k] is None:
            out.append(None)
            continue
        out.append(torch.where(cond, 0.0 if ac[k] is None else ac[k],
                               0.0 if bc[k] is None else bc[k]))
    return Jet(out)


def _extremum(pick):
    """``maximum`` / ``minimum``: the picked argument's coefficients, the
    mean of both at a tie (``jax.jvp``'s convention)."""
    def rule(func, args, kwargs):
        a, b = args[0], args[1]
        m = _order_of((a, b))
        ac, bc = _coefs(a, m), _coefs(b, m)
        first = pick(ac[0], bc[0])
        second = pick(bc[0], ac[0])
        out = [func(_value(a), _value(b))]
        for k in range(1, 1 << m):
            if ac[k] is None and bc[k] is None:
                out.append(None)
                continue
            da = 0.0 if ac[k] is None else ac[k]
            db = 0.0 if bc[k] is None else bc[k]
            out.append(torch.where(first, da, torch.where(
                second, db, 0.5 * (da + db))))
        return Jet(out)
    return rule


def _clamp_rule(func, args, kwargs):
    x = args[0]
    lo = args[1] if len(args) > 1 else kwargs.get("min")
    hi = args[2] if len(args) > 2 else kwargs.get("max")
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x


def _layer_norm_rule(func, args, kwargs):
    x, shape = args[0], tuple(args[1])
    weight = args[2] if len(args) > 2 else kwargs.get("weight")
    bias = args[3] if len(args) > 3 else kwargs.get("bias")
    eps = args[4] if len(args) > 4 else kwargs.get("eps", 1e-5)
    dims = tuple(range(-len(shape), 0))
    xc = x - x.mean(dim=dims, keepdim=True)
    y = xc * torch.rsqrt((xc * xc).mean(dim=dims, keepdim=True) + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    y.c[0] = F.layer_norm(_value(x), shape, _value(weight), _value(bias),
                          eps)
    return y


def _gelu_deriv(x, y, approximate="none"):
    if approximate == "tanh":
        k = math.sqrt(2.0 / math.pi)
        t = torch.tanh(k * (x + 0.044715 * x * x * x))
        return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * k * (
            1.0 + 3 * 0.044715 * x * x)
    return 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0)))) + x * (
        1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * x * x)


def _softplus_deriv(x, y, beta=1.0, threshold=20.0):
    return torch.sigmoid(x * beta)


def _elu_deriv(x, y, alpha=1.0, inplace=False):
    return torch.where(_value(x) > 0, 1.0, y + alpha)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def _selu_deriv(x, y, inplace=False):
    return torch.where(_value(x) > 0, _SELU_SCALE, y + _SELU_SCALE
                       * _SELU_ALPHA)


def _leaky_deriv(x, y, negative_slope=0.01, inplace=False):
    v = _value(x)
    return torch.where(v >= 0, 1.0, negative_slope).to(v.dtype)


def _hardtanh_deriv(x, y, min_val=-1.0, max_val=1.0, inplace=False):
    v = _value(x)
    return ((v >= min_val) & (v <= max_val)).to(v.dtype)


def _relu6_deriv(x, y, inplace=False):
    v = _value(x)
    return ((v > 0) & (v < 6)).to(v.dtype)


def _relu_deriv(x, y, inplace=False):
    v = _value(x)
    return (v > 0).to(v.dtype)


def _mish_deriv(x, y, inplace=False):
    t = torch.tanh(F.softplus(x))
    return t + x * torch.sigmoid(x) * (1.0 - t * t)


def _silu_deriv(x, y, inplace=False):
    s = torch.sigmoid(x)
    return s + x * s * (1.0 - s)


_register(_each, "reshape", "view", "unsqueeze", "squeeze", "expand",
          "expand_as", "permute", "transpose", "t", "flatten", "narrow",
          "select", "sum", "mean", "neg", "contiguous", "clone", "to",
          "float", "__getitem__", "__neg__")
_register(_sequence, "cat", "concat", "stack")
_register(_on_value, "dim", "size", "numel", "zeros_like", "ones_like",
          "full_like", "new_zeros", "new_ones", "new_full", "sign", "lt",
          "le", "gt", "ge", "eq", "ne", "__lt__", "__le__", "__gt__",
          "__ge__", "__eq__", "__ne__")
_register(_arith(Jet.__add__), "add", "__add__")
_register(_arith(Jet.__sub__), "sub", "__sub__")
_register(lambda f, a, k: a[1] + a[0], "__radd__")
_register(lambda f, a, k: a[1] - a[0], "__rsub__", "rsub")
_register(_mul_rule, "mul", "__mul__", "__rmul__")
_register(_div_rule, "div", "true_divide", "__truediv__")
_register(lambda f, a, k: _quotient(a[1], a[0]), "__rtruediv__")
_register(_pow_rule, "pow", "__pow__")
_register(lambda f, a, k: _pow_rule(f, (a[1], a[0]), k), "__rpow__")
_register(lambda f, a, k: a[0] * a[0], "square")
_register(_matmul_rule(torch.matmul), "matmul", "__matmul__")
_register(lambda f, a, k: _multilinear((a[1], a[0]), torch.matmul,
                                       torch.matmul), "__rmatmul__")
_register(_matmul_rule(torch.mm), "mm")
_register(_linear_rule, "linear")
_register(_addmm_rule, "addmm")
_register(_einsum_rule, "einsum")
_register(_where_rule, "where")
_register(_extremum(torch.gt), "maximum")
_register(_extremum(torch.lt), "minimum")
_register(_clamp_rule, "clamp", "clip")
_register(_layer_norm_rule, "layer_norm")
_register(lambda f, a, k: sigmoid(a[0]), "sigmoid")
_register(_unary(lambda x, y: 1.0 - y * y), "tanh")
_register(_unary(lambda x, y: y), "exp")
_register(_unary(lambda x, y: y + 1.0), "expm1")
_register(_unary(lambda x, y: 1.0 / x), "log")
_register(_unary(lambda x, y: 1.0 / (1.0 + x)), "log1p")
_register(_unary(lambda x, y: 1.0 / (x * math.log(2.0))), "log2")
_register(_unary(lambda x, y: 1.0 / (x * math.log(10.0))), "log10")
_register(_unary(lambda x, y: 0.5 / y), "sqrt")
_register(_unary(lambda x, y: -0.5 * y * y * y), "rsqrt")
_register(_unary(lambda x, y: -(y * y)), "reciprocal")
_register(_unary(lambda x, y: torch.cos(x)), "sin")
_register(_unary(lambda x, y: -torch.sin(x)), "cos")
_register(_unary(lambda x, y: 1.0 + y * y), "tan")
_register(_unary(lambda x, y: torch.cosh(x)), "sinh")
_register(_unary(lambda x, y: torch.sinh(x)), "cosh")
_register(_unary(lambda x, y: torch.rsqrt(1.0 - x * x)), "arcsin", "asin")
_register(_unary(lambda x, y: -torch.rsqrt(1.0 - x * x)), "arccos", "acos")
_register(_unary(lambda x, y: 1.0 / (1.0 + x * x)), "arctan", "atan")
_register(lambda f, a, k: _chain(
    torch.arctan2, lambda p, q, y: [q / (p * p + q * q),
                                    -p / (p * p + q * q)], a[:2]),
    "arctan2", "atan2")
_register(_unary(lambda x, y: (2.0 / math.sqrt(math.pi))
                 * torch.exp(-(x * x))), "erf")
_register(_unary(lambda x, y: torch.where(_value(x) >= 0, 1.0, -1.0).to(
    y.dtype)), "abs", "absolute", "__abs__")
_register(_unary(_relu_deriv), "relu")
_register(_unary(_relu6_deriv), "relu6")
_register(_unary(_leaky_deriv), "leaky_relu")
_register(_unary(_elu_deriv), "elu")
_register(_unary(lambda x, y, alpha=1.0, inplace=False: torch.where(
    _value(x) > 0, 1.0, y / alpha + 1.0)), "celu")
_register(_unary(_selu_deriv), "selu")
_register(_unary(_gelu_deriv), "gelu")
_register(_unary(_silu_deriv), "silu")
_register(_unary(_softplus_deriv), "softplus")
_register(_unary(lambda x, y: 1.0 / ((1.0 + torch.abs(x))
                                     * (1.0 + torch.abs(x)))), "softsign")
_register(_unary(_mish_deriv), "mish")
_register(_unary(_hardtanh_deriv), "hardtanh")

# numpy ufuncs a condition may call on a jet, by their torch twins.
_UFUNCS = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "true_divide": torch.div, "power": torch.pow, "negative": torch.neg,
    "square": torch.square, "sqrt": torch.sqrt, "exp": torch.exp,
    "expm1": torch.expm1, "log": torch.log, "log1p": torch.log1p,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.arcsin, "arccos": torch.arccos, "arctan": torch.arctan,
    "arctan2": torch.arctan2, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "absolute": torch.abs, "maximum": torch.maximum,
    "minimum": torch.minimum,
}
