"""Layout-string network builder, in PyTorch.

Counterpart of ``pydens_tpu/models/layout.py``.  Grammar of the ported
subset:

* ``f`` — fully connected (dense) layer
* ``c`` — convolutional layer; on ``(N, D)`` point clouds a dense layer
* ``a`` — activation
* ``R`` — start of a skip connection (push the current tensor)
* ``+`` — end of a skip connection via sum (pop and add)
* spaces are cosmetic

The branch/join/norm superset (``B``, ``*``, ``.``, ``n``) is scheduled in
ROADMAP.md, Queue 1 item 11, and raises ``NotImplementedError`` here.

Dense weights keep the JAX storage layout — ``w: (fan_in, fan_out)``,
``b: (fan_out,)`` — so parameters copy between the two packages unchanged
and the CUDA kernels read the same operand order as the Pallas ones.

A network is an ``nn.Module`` holding its ``nn.Parameter``s, with a
functional :meth:`LayoutNetwork.apply` that takes an explicit parameter
dict: the Solver trains views into one flat parameter vector.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["parse_layout", "make_layout_network", "LayoutNetwork",
           "ACTIVATIONS", "resolve_activation"]


def _identity(x):
    return x


# Exact twins of the JAX definitions.  Note ``jax.nn.gelu`` defaults to the
# tanh approximation while ``torch.nn.functional.gelu`` defaults to the
# exact erf form.
ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "relu6": F.relu6,
    "leakyrelu": F.leaky_relu,
    "elu": F.elu,
    "selu": F.selu,
    "celu": F.celu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "mish": F.mish,
    "hardtanh": F.hardtanh,
    "sin": torch.sin,
    "cos": torch.cos,
    "identity": _identity,
    "linear": _identity,
    "none": _identity,
}

# Every table entry acts elementwise (diagonal Jacobian), which the Taylor
# traversal needs; a user callable is not probed and disables the plan.
_ELEMENTWISE = frozenset(id(fn) for fn in ACTIVATIONS.values())

_PARTITIONS_CACHE = {}

_NOT_PORTED_TOKENS = {
    "B": "branch start", "n": "LayerNorm", "*": "product join",
    ".": "concat join"}


def _set_partitions(m):
    """All set partitions of positions ``0..m-1`` (cached): list of
    partitions, each a tuple of blocks, each block a sorted tuple of
    positions — the index set of the order-``m`` Faà di Bruno rule."""
    if m in _PARTITIONS_CACHE:
        return _PARTITIONS_CACHE[m]
    if m == 0:
        parts = [()]
    else:
        parts = []
        for sub in _set_partitions(m - 1):
            for i in range(len(sub)):
                parts.append(sub[:i] + (sub[i] + (m - 1,),) + sub[i + 1:])
            parts.append(sub + ((m - 1,),))
    _PARTITIONS_CACHE[m] = parts
    return parts


def _act_taps(act, V, taps, closure, max_order):
    """Taylor state through an elementwise activation: the order-``m`` Faà
    di Bruno rule over set partitions, with ``σ', σ'', ...`` from nested
    ``torch.func.jvp``-with-ones.  Returns ``(σ(V), new_taps)``."""
    sV, d1 = torch.func.jvp(act, (V,), (torch.ones_like(V),))
    d = {1: d1}
    fk = act
    for k in range(2, max_order + 1):
        fk = (lambda f: lambda z: torch.func.jvp(
            f, (z,), (torch.ones_like(z),))[1])(fk)
        d[k] = torch.func.jvp(fk, (V,), (torch.ones_like(V),))[1]
    new_taps = {}
    for mi in closure:
        total = None
        for part in _set_partitions(len(mi)):
            term = d[len(part)]
            for block in part:
                term = term * taps[tuple(sorted(mi[i] for i in block))]
            total = term if total is None else total + term
        new_taps[mi] = total
    return sV, new_taps


def _dense_taps(layer, V, taps, closure):
    """Taylor state through a dense layer: one stacked matmul moves the
    value and every tap; the bias lands on the value only."""
    blocks = [V] + [taps[mi] for mi in closure]
    out = torch.cat(blocks, dim=0) @ layer["w"]
    parts = torch.split(out, V.shape[0], dim=0)
    return (parts[0] + layer["b"],
            {mi: parts[1 + i] for i, mi in enumerate(closure)})


def _identity_state(x, closure):
    """Default input Taylor state: one-hot tangents, zero curvature."""
    n, in_dim = x.shape
    taps = {}
    for mi in closure:
        t = x.new_zeros((n, in_dim))
        if len(mi) == 1:
            t[:, mi[0]].fill_(1.0)
        taps[mi] = t
    return x, taps


def _validate_closure(closure):
    """Sorted, non-empty, downward-closed multi-indices."""
    cset = set(closure)
    for mi in closure:
        if tuple(sorted(mi)) != mi or not mi:
            raise ValueError(
                f"closure entries must be sorted non-empty "
                f"multi-indices; got {mi}")
        for i in range(len(mi)):
            sub = mi[:i] + mi[i + 1:]
            if sub and sub not in cset:
                raise ValueError(
                    f"closure entry {mi} needs sub-multi-index {sub} "
                    "(the activation chain rule reads it); pass sets "
                    "from Model.plan_closure")


def resolve_activation(act):
    """Resolve an activation spec (str, callable, or class) to a torch
    callable; names and torch functions resolve to the table entry."""
    if isinstance(act, str):
        key = act.lower().replace("_", "")
        if key not in ACTIVATIONS:
            raise ValueError(
                f"unknown activation {act!r}; known: {sorted(ACTIVATIONS)} "
                "or pass any torch-compatible callable")
        return ACTIVATIONS[key]
    if isinstance(act, type):
        key = act.__name__.lower().replace("_", "")
        if key in ACTIVATIONS:
            return ACTIVATIONS[key]
        raise ValueError(
            f"cannot resolve activation class {act!r}; pass a callable or "
            "a known name")
    if callable(act):
        name = getattr(act, "__name__", "").lower()
        mod = getattr(act, "__module__", "") or ""
        if mod.startswith("torch") and name in ACTIVATIONS:
            return ACTIVATIONS[name]
        return act
    raise ValueError(f"cannot interpret activation spec {act!r}")


def parse_layout(layout):
    """Parse a layout string into a token list; validates characters and
    skip balance."""
    tokens = [ch for ch in layout if ch != " "]
    for ch in tokens:
        if ch in _NOT_PORTED_TOKENS:
            raise NotImplementedError(
                f"layout token {ch!r} ({_NOT_PORTED_TOKENS[ch]}) is not "
                "ported to pydens_tpu_torch yet (ROADMAP.md, Queue 1 item "
                "11); supported: 'f', 'c', 'a', 'R', '+'")
        if ch not in ("f", "c", "a", "R", "+"):
            raise ValueError(
                f"unknown layout token {ch!r} in layout {layout!r}; "
                "supported tokens: 'f' (dense), 'c' (conv, dense on point "
                "clouds), 'a' (activation), 'R' (skip start), '+' (skip "
                "end)")
    depth = 0
    for ch in tokens:
        if ch == "R":
            depth += 1
        elif ch == "+":
            depth -= 1
            if depth < 0:
                raise ValueError(
                    f"layout {layout!r}: join '+' with no matching 'R'")
    if depth != 0:
        raise ValueError(f"layout {layout!r}: unmatched 'R' skip start")
    return tokens


class Dense(nn.Module):
    """One dense layer in the JAX storage layout."""

    def __init__(self, fan_in, fan_out, dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty((fan_in, fan_out), dtype=dtype,
                                          device=device))
        self.b = nn.Parameter(torch.empty((fan_out,), dtype=dtype,
                                          device=device))

    def reset_parameters(self, generator):
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases (the
        torch.nn.Linear default), drawn on the CPU from ``generator``."""
        bound = 1.0 / math.sqrt(self.w.shape[0])
        with torch.no_grad():
            for p in (self.w, self.b):
                draw = torch.rand(p.shape, generator=generator,
                                  dtype=p.dtype)
                p.copy_(draw * (2 * bound) - bound)


class LayoutNetwork(nn.Module):
    """A layout-string MLP: parameters ``fc1``, ``fc2``, ... (1-based, as
    the reference's ``freeze_layers(['fc1', ...])`` names them)."""

    def __init__(self, layout, features, activation, in_dim,
                 dtype=torch.float32, device=None):
        super().__init__()
        tokens = parse_layout(layout)
        n_dense = sum(1 for t in tokens if t in ("f", "c"))
        n_act = sum(1 for t in tokens if t == "a")
        features = list(features)
        if len(features) != n_dense:
            raise ValueError(
                f"layout {layout!r} has {n_dense} dense layers but "
                f"features/units has {len(features)} entries")
        if isinstance(activation, (list, tuple)):
            if len(activation) == n_act:
                acts = [resolve_activation(a) for a in activation]
            elif len(activation) == 1:
                acts = [resolve_activation(activation[0])] * n_act
            else:
                raise ValueError(
                    f"layout {layout!r} has {n_act} activation slots but "
                    f"activation sequence has {len(activation)} entries")
        else:
            acts = [resolve_activation(activation)] * n_act

        # Symbolic pass: per-layer input widths, skip widths.
        in_dims, widths, stack = [], [], []
        cur, di = in_dim, 0
        for tok in tokens:
            if tok in ("f", "c"):
                in_dims.append(cur)
                cur = features[di]
                di += 1
            elif tok == "R":
                stack.append(cur)
            elif tok == "+":
                skip = stack.pop()
                if skip != cur:
                    raise ValueError(
                        f"layout {layout!r}: skip connection joins width "
                        f"{skip} with width {cur}; sum-skips require equal "
                        "widths")
            widths.append(cur)

        self.layout = layout
        self.tokens = tokens
        self.activations = acts
        self.in_dim = in_dim
        self.out_dim = cur
        self.layer_names = [f"fc{i + 1}" for i in range(n_dense)]
        self.layer_shapes = list(zip(in_dims, features))
        self.taylor_ok = all(id(a) in _ELEMENTWISE for a in acts)
        self.layers = nn.ModuleDict({
            name: Dense(fan_in, fan_out, dtype, device)
            for name, (fan_in, fan_out) in zip(self.layer_names,
                                               self.layer_shapes)})

    def reset_parameters(self, generator):
        for name in self.layer_names:
            self.layers[name].reset_parameters(generator)

    def params(self):
        """The live parameters as a ``{name: {'w', 'b'}}`` dict."""
        return {name: {"w": layer.w, "b": layer.b}
                for name, layer in self.layers.items()}

    def apply(self, params, x):
        """Apply the network to a ``(N, in_dim)`` batch of points."""
        h = x
        stack = []
        di, ai = 0, 0
        for tok in self.tokens:
            if tok in ("f", "c"):
                layer = params[self.layer_names[di]]
                h = h @ layer["w"] + layer["b"]
                di += 1
            elif tok == "a":
                h = self.activations[ai](h)
                ai += 1
            elif tok == "R":
                stack.append(h)
            elif tok == "+":
                h = h + stack.pop()
        return h

    def forward(self, x):
        return self.apply(self.params(), x)

    def taylor_taps(self, params, x, closure):
        """Single-traversal Taylor-mode propagation: the network value plus
        every directional-derivative tap in ``closure`` (downward-closed
        sorted multi-indices over input columns), in ONE pass with
        batched-tangent matmuls.  Returns ``(V, {multi-index: tap})``."""
        closure = [tuple(mi) for mi in closure]
        _validate_closure(closure)
        V, taps = _identity_state(x, closure)
        max_order = max((len(mi) for mi in closure), default=0)
        stack = []
        di, ai = 0, 0
        for tok in self.tokens:
            if tok in ("f", "c"):
                V, taps = _dense_taps(params[self.layer_names[di]], V, taps,
                                      closure)
                di += 1
            elif tok == "a":
                V, taps = _act_taps(self.activations[ai], V, taps, closure,
                                    max_order)
                ai += 1
            elif tok == "R":
                stack.append((V, dict(taps)))
            elif tok == "+":
                V0, taps0 = stack.pop()
                V = V + V0
                taps = {mi: taps[mi] + taps0[mi] for mi in closure}
        return V, taps


def make_layout_network(layout, features, activation, in_dim,
                        dtype=torch.float32, device=None):
    """Build a :class:`LayoutNetwork` (parameters uninitialized until
    :meth:`LayoutNetwork.reset_parameters`)."""
    return LayoutNetwork(layout, features, activation, in_dim, dtype=dtype,
                         device=device)
