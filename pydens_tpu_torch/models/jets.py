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
"""

from __future__ import annotations

import torch

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
        """Division by a constant (a tensor or a number)."""
        return Jet([None if a is None else a / other for a in self.c])

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
