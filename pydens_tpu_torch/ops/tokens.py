"""Differentiation (``D``) and trainable-variable (``V``) tokens, in PyTorch.

Counterpart of ``pydens_tpu/ops/tokens.py``.  PyTorch keeps a dynamic tape,
so the nested-derivative path is the reference PyDEns mechanism itself
(``model_torch.py:174-178``): ``D(y, x)`` is
``torch.autograd.grad(y.sum(), x, create_graph=True)`` on the batch-diagonal
leaf column ``x`` — every coordinate is its own ``(N, 1)`` leaf and each row
of ``y`` depends on its own row only, so the gradient of the sum is the
per-point partial.

Quantities inside an equation callable are lazy :class:`Expr` nodes, as in
the JAX package, so the Solver can plan derivatives: the init-time discovery
run records which pure field taps the equation takes, and under a plan the
training step computes all of them in ONE Taylor traversal
(``Model.full_taps``) and ``Expr`` evaluation reads them from the table
instead of taking nested gradients.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["Expr", "D", "V", "variable_scope", "member_scope", "member_value",
           "as_array", "lift", "EvalContext", "PLAN_MAX_ORDER", "staging",
           "as_device"]

# Highest derivative order the Taylor plan will schedule (Bell(n) activation
# terms and 2^n - 1 ansatz cross terms grow steeply past it); deeper nesting
# takes the nested-gradient path, which is always correct.
PLAN_MAX_ORDER = 6


class EvalContext:
    """Shared evaluation context: the leaf columns of one equation
    evaluation, the derivative-planning record (``derivs``, ``plan_ok``)
    and, under a plan, the precomputed tap ``table``."""

    __slots__ = ("leaves", "derivs", "plan_ok", "table")

    def __init__(self, leaves, table=None):
        self.leaves = list(leaves)
        self.derivs = set()
        self.plan_ok = True
        self.table = table  # dict: multi-index tuple -> (N, k) tensor


_STAGING = []  # stack of {key: device tensor} stores of staged host values


@contextlib.contextmanager
def staging(store):
    """Scope under which :func:`as_device` copies each distinct host value
    to the device once and returns that copy afterwards: the Solver enters
    it for the eager warm-up step of a CUDA-graph fit step (which fills
    ``store``) and for the capture (which then makes no host-to-device
    copy)."""
    _STAGING.append(store)
    try:
        yield store
    finally:
        _STAGING.pop()


def as_device(value, device, dtype=None):
    """``torch.as_tensor(value, dtype=dtype, device=device)``, except that
    under :func:`staging` a host value (numpy, number, CPU tensor) bound for
    the card is copied once per distinct value and kept.  A value first met
    while a CUDA graph is being captured raises: the capture would bake a
    copy from a host address into the graph."""
    device = torch.device(device)
    if (not _STAGING or device.type == "cpu"
            or (torch.is_tensor(value) and (value.device.type != "cpu"
                                            or value.requires_grad))):
        return torch.as_tensor(value, dtype=dtype, device=device)
    host = (value.numpy() if torch.is_tensor(value) else np.asarray(value))
    key = (type(value), device, dtype, host.dtype.str, host.shape,
           host.tobytes())
    store = _STAGING[-1]
    if key not in store:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"a host value of shape {host.shape} reached the device for "
                "the first time while the fit step was captured as a CUDA "
                "graph: it differs from the value of the warm-up step. "
                "Values from numpy or Python in an equation, a condition "
                "or a constraint must not change from step to step; "
                "compute changing values with torch from the coordinates")
        store[key] = torch.as_tensor(value, dtype=dtype, device=device)
    return store[key]


def _const(a, ref):
    """A numpy operand as a tensor beside ``ref``; anything else as-is."""
    if isinstance(a, (np.ndarray, np.generic)):
        return as_device(np.asarray(a), ref.device)
    return a


class Expr:
    """A lazy, differentiable quantity inside an equation callable.

    Wraps ``fn() -> tensor`` evaluated on the context's leaves.  Supports
    the numeric operator protocol; plain tensors, arrays and numbers mix in
    as constants.  ``torch.*`` functions (``torch.sin(np.pi * (x + y))``,
    the README's own spelling) and numpy ufuncs dispatch on an ``Expr`` and
    stay symbolic through :func:`lift`.
    """

    __slots__ = ("fn", "ctx", "leaf_index", "deriv", "post", "_value",
                 "_has_value")

    def __init__(self, fn, ctx, leaf_index=None, deriv=None, post=None):
        self.fn = fn
        self.ctx = ctx
        self.leaf_index = leaf_index
        # Pure-field-derivative multi-index (sorted tuple of leaf indices;
        # () = the field itself).  None = not a pure field tap.
        self.deriv = deriv
        # Component selection applied after a table lookup.
        self.post = post
        self._value = None
        self._has_value = False

    def _eval(self):
        if self.deriv is not None and self.ctx.table is not None:
            if self.deriv not in self.ctx.table:
                raise KeyError(
                    f"field derivative {self.deriv} was not planned at "
                    "Solver construction — the equation callable requested "
                    "different derivatives than it did during the init-time "
                    "discovery run.  Equation callables must be "
                    "deterministic; as a workaround pass "
                    "fit(fast_taps=False).")
            v = self.ctx.table[self.deriv]
            return self.post(v) if self.post is not None else v
        return self.fn()

    @property
    def value(self):
        if not self._has_value:
            self._value = self._eval()
            self._has_value = True
        return self._value

    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return self.value.dtype

    def __repr__(self):
        return ("Expr(a pydens_tpu_torch symbolic expression; use torch "
                "functions, the pydens_tpu_torch math functions or "
                "pydens_tpu_torch.lift on it)")

    # -- algebra ------------------------------------------------------------
    def _unary(self, op):
        return Expr(lambda: op(self.value), self.ctx)

    def _binary(self, other, op, reflected=False):
        if isinstance(other, Expr):
            if reflected:
                return Expr(lambda: op(other.value, self.value), self.ctx)
            return Expr(lambda: op(self.value, other.value), self.ctx)

        def fn():
            v = self.value
            c = _const(other, v)
            return op(c, v) if reflected else op(v, c)
        return Expr(fn, self.ctx)

    def __add__(self, o):
        return self._binary(o, torch.add)

    def __radd__(self, o):
        return self._binary(o, torch.add, reflected=True)

    def __sub__(self, o):
        return self._binary(o, torch.sub)

    def __rsub__(self, o):
        return self._binary(o, torch.sub, reflected=True)

    def __mul__(self, o):
        return self._binary(o, torch.mul)

    def __rmul__(self, o):
        return self._binary(o, torch.mul, reflected=True)

    def __truediv__(self, o):
        return self._binary(o, torch.true_divide)

    def __rtruediv__(self, o):
        return self._binary(o, torch.true_divide, reflected=True)

    def __pow__(self, o):
        return self._binary(o, torch.pow)

    def __rpow__(self, o):
        return self._binary(o, torch.pow, reflected=True)

    def __mod__(self, o):
        return self._binary(o, torch.remainder)

    def __matmul__(self, o):
        return self._binary(o, torch.matmul)

    def __neg__(self):
        return self._unary(torch.neg)

    def __pos__(self):
        return self

    def __abs__(self):
        return self._unary(torch.abs)

    def __getitem__(self, idx):
        out = self._unary(lambda v: v[idx])
        if self.deriv is not None:
            # Component slicing of a pure field tap stays pure.
            out.deriv = self.deriv
            prev = self.post
            out.post = ((lambda v: prev(v)[idx]) if prev is not None
                        else (lambda v: v[idx]))
        return out

    # -- numpy / torch interop ----------------------------------------------
    _NP_TO_TORCH = {"power": "pow"}

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or kwargs.get("out") is not None:
            raise TypeError(
                f"numpy ufunc method {ufunc.__name__}.{method} is not "
                "supported on symbolic expressions; use torch functions or "
                "pydens_tpu_torch.lift")
        tfn = getattr(torch, self._NP_TO_TORCH.get(ufunc.__name__,
                                                   ufunc.__name__), None)
        if tfn is None:
            raise TypeError(
                f"numpy ufunc {ufunc.__name__!r} has no torch equivalent to "
                "apply symbolically; wrap a torch function with "
                "pydens_tpu_torch.lift instead")
        return lift(tfn)(*inputs, **kwargs)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return lift(func)(*args, **(kwargs or {}))

    # Comparisons materialize — they are not differentiable anyway.
    def __lt__(self, o):
        return self.value < _materialize(o)

    def __le__(self, o):
        return self.value <= _materialize(o)

    def __gt__(self, o):
        return self.value > _materialize(o)

    def __ge__(self, o):
        return self.value >= _materialize(o)

    def __eq__(self, o):
        return self.value == _materialize(o)

    def __ne__(self, o):
        return self.value != _materialize(o)

    __hash__ = object.__hash__


def _materialize(x):
    return x.value if isinstance(x, Expr) else x


def as_array(x):
    """Evaluate ``x`` to a tensor: Expr -> value, else ``torch.as_tensor``."""
    return x.value if isinstance(x, Expr) else torch.as_tensor(x)


def lift(tfn):
    """Wrap a torch-compatible function so it stays symbolic on
    :class:`Expr` positional arguments (keyword arguments are constants)."""

    def wrapped(*args, **kwargs):
        ctx = next((a.ctx for a in args if isinstance(a, Expr)), None)
        if ctx is None:
            return tfn(*args, **kwargs)

        def fn():
            vals = [a.value if isinstance(a, Expr) else a for a in args]
            ref = next(v for a, v in zip(args, vals) if isinstance(a, Expr))
            return tfn(*[_const(v, ref) for v in vals], **kwargs)

        return Expr(fn, ctx)

    wrapped.__name__ = getattr(tfn, "__name__", "lifted")
    wrapped.__doc__ = f"Symbolic (Expr-aware) version of {wrapped.__name__}."
    return wrapped


def _batch_diagonal_grad(y, leaf):
    """Per-point partial of every column of ``y`` w.r.t. the ``(N, 1)`` leaf
    column (one ``autograd.grad`` per output column; graph kept for the
    outer derivative and the parameter gradient)."""
    if not leaf.requires_grad:
        raise RuntimeError(
            "D(y, x) took the nested-gradient path on a coordinate leaf "
            "that does not require grad; evaluate equations through the "
            "Solver")
    if not y.requires_grad:  # constant w.r.t. the coordinates
        return torch.zeros_like(y if y.ndim == 2 else leaf)

    def grad_of(s):
        g, = torch.autograd.grad(s, leaf, create_graph=True,
                                 allow_unused=True)
        return torch.zeros_like(leaf) if g is None else g

    if y.ndim == 2 and y.shape[1] > 1:
        return torch.cat([grad_of(y[:, c].sum()) for c in range(y.shape[1])],
                         dim=1)
    return grad_of(y.sum())


def D(y, x):
    """Differentiation token: per-point partial derivative of ``y`` w.r.t.
    the coordinate symbol ``x`` (the reference's
    ``grad(y.sum(), x, create_graph=True)[0]``); composes to any order."""
    if not isinstance(x, Expr) or x.leaf_index is None:
        raise TypeError(
            "D(y, x): `x` must be one of the coordinate symbols passed into "
            "the equation callable (got {!r}). Differentiation is only "
            "defined w.r.t. the sampled coordinates/parameters.".format(
                type(x)))
    if not isinstance(y, Expr):
        raise TypeError(
            "D(y, x): `y` must be a differentiable expression built from the "
            "equation's field `f` and coordinate symbols (got {!r}). Use "
            "torch functions or the pydens_tpu_torch math functions on the "
            "symbols to keep subexpressions differentiable.".format(type(y)))

    k = x.leaf_index
    ctx = y.ctx

    def dfn():
        return _batch_diagonal_grad(y.value, ctx.leaves[k])

    # Derivative planning: pure field taps of order <= PLAN_MAX_ORDER are
    # recorded; deeper nesting or a D of a composite voids the plan.
    deriv = None
    if y.deriv is not None:
        candidate = tuple(sorted(y.deriv + (k,)))
        if len(candidate) <= PLAN_MAX_ORDER:
            deriv = candidate
            ctx.derivs.add(candidate)
        else:
            ctx.plan_ok = False
    else:
        ctx.plan_ok = False

    return Expr(dfn, ctx, deriv=deriv, post=y.post if deriv else None)


_VAR_SCOPES = []  # stack of (mode, store, device)
_MEMBER_SCOPES = []  # stack of (n_models, rows per member)


@contextlib.contextmanager
def member_scope(n_models, rows):
    """Scope under which ``V`` reads an ensemble's variables: each
    member's value repeated over its ``rows`` member-major rows, so that
    ``(n_models * rows, c)`` residuals and conditions broadcast against
    their own member's value as a single model's ``(rows, c)`` ones do
    against its value."""
    _MEMBER_SCOPES.append((int(n_models), int(rows)))
    try:
        yield
    finally:
        _MEMBER_SCOPES.pop()


def member_value(value, n_models, rows):
    """A per-member value ``(K,) + S`` as member-major rows: ``(K * rows,
    c)`` for ``S`` of ``()``, ``(c,)`` or ``(1, c)``; a single model's
    value as it is."""
    if n_models == 1:
        return value
    shape = tuple(value.shape[1:])
    if len(shape) > 2 or (len(shape) == 2 and shape[0] != 1):
        raise ValueError(
            f"an ensemble's V variable of shape {shape} per member: only "
            "scalars, (c,) and (1, c) broadcast per point")
    c = shape[-1] if shape else 1
    return value.reshape(n_models, 1, c).expand(n_models, rows, c).reshape(
        n_models * rows, c)


@contextlib.contextmanager
def variable_scope(mode, store, device=None):
    """Scope under which ``V`` resolves.

    ``mode='create'``: first use of a name registers its initial value (a
    float32 numpy array) in ``store`` — the analogue of the reference's
    fake run (``model_torch.py:319-325``); values come back as tensors on
    ``device``.  ``mode='read'``: names resolve to the tensors in ``store``.
    """
    if mode not in ("create", "read"):
        raise ValueError(f"unknown variable scope mode {mode!r}")
    _VAR_SCOPES.append((mode, store, device))
    try:
        yield store
    finally:
        _VAR_SCOPES.pop()


def _to_initial_value(data):
    if hasattr(data, "detach"):
        data = data.detach().cpu().numpy()
    return np.asarray(data, dtype=np.float32)


def V(name, *args, **kwargs):
    """Trainable-variable token (``V('a', data=[3.0])``, ``V('a', 3.0)``,
    ``V('a', data=torch.Tensor([3.0]), requires_grad=True)``): created from
    its initial value during the Solver's discovery run, afterwards the
    current trainable tensor."""
    if not _VAR_SCOPES:
        raise RuntimeError(
            "V token used outside of a Solver context. V only works inside "
            "equation/initial-condition callables evaluated by a Solver.")
    mode, store, device = _VAR_SCOPES[-1]
    if mode == "create":
        if name not in store:
            data = kwargs.get("data", args[0] if args else None)
            if data is None:
                raise ValueError(
                    f"V({name!r}): an initial value is required on first "
                    f"use, e.g. V({name!r}, data=[1.0])")
            store[name] = _to_initial_value(data)
        return torch.as_tensor(store[name], device=device)
    if name not in store:
        raise KeyError(
            f"V({name!r}): variable was not created during Solver "
            "initialization. Variables must be reachable from the equation "
            "or initial condition at Solver construction time.")
    if _MEMBER_SCOPES:
        return member_value(store[name], *_MEMBER_SCOPES[-1])
    return store[name]
