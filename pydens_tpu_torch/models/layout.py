"""Layout-string network builder, in PyTorch.

Counterpart of ``pydens_tpu/models/layout.py``.  Grammar:

* ``f`` — fully connected (dense) layer
* ``c`` — convolutional layer; on ``(N, D)`` point clouds a dense layer
* ``a`` — activation
* ``n`` — LayerNorm over the feature axis (trainable ``g``/``b``, layer
  names ``ln1``, ``ln2``, ...); its Jacobian mixes features, so a network
  with one takes nested gradients instead of the Taylor traversal
* ``R`` — start of a skip connection (push the current tensor)
* ``B`` — branch start: push the current tensor, routed through the
  branch's own sub-network when ``branches=`` gives one (its layers named
  ``br{i}_...`` for the ``i``-th ``B``)
* ``+`` / ``*`` / ``.`` — join the most recent ``R`` or ``B`` by sum,
  elementwise product or feature concatenation (the branch's features
  after the main path's)
* spaces are cosmetic

``adaptive_activation=n`` gives every ``a`` slot one trainable slope
``aa{i}`` applied as ``σ(n·a·h)`` (L-LAAF), ``a`` starting at ``1/n``;
branches take their own slopes.  :func:`make_modified_mlp_network` builds
the gated modified MLP.

Dense weights keep the JAX storage layout — ``w: (fan_in, fan_out)``,
``b: (fan_out,)`` — so parameters copy between the two packages unchanged
and the CUDA kernels read the same operand order as the Pallas ones.

A network is an ``nn.Module`` holding its ``nn.Parameter``s, with a
functional :meth:`LayoutNetwork.apply` that takes an explicit parameter
dict: the Solver trains views into one flat parameter vector.
"""

from __future__ import annotations

import math
import weakref

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["parse_layout", "make_layout_network", "LayoutNetwork",
           "make_modified_mlp_network", "ModifiedMLPNetwork", "ACTIVATIONS",
           "resolve_activation"]


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

_PARTITIONS_CACHE = {}
_ELEMENTWISE_CACHE = weakref.WeakKeyDictionary()  # keeps no callable alive
_JOINS = ("+", "*", ".")


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


def _product_taps(Va, ta, Vb, tb, closure):
    """Taylor state of an elementwise product ``a * b`` from its factors':
    the general Leibniz rule over position subsets,
    ``(a·b)_(p) = Σ_{S ⊆ positions(p)} a_(p[S]) · b_(p[S̄])`` (the empty
    subset reads the factor's value), so repeated indices get their
    multiplicities: at ``p = (0, 0)`` it is ``a₀₀b + 2a₀b₀ + ab₀₀``."""
    new_taps = {}
    for mi in closure:
        m = len(mi)
        total = None
        for mask in range(1 << m):
            sa = tuple(sorted(mi[i] for i in range(m) if mask >> i & 1))
            sb = tuple(sorted(mi[i] for i in range(m) if not mask >> i & 1))
            term = (ta[sa] if sa else Va) * (tb[sb] if sb else Vb)
            total = term if total is None else total + term
        new_taps[mi] = total
    return Va * Vb, new_taps


def _feature(t):
    """A per-feature parameter (a bias, a LayerNorm scale, a slope) shaped
    to broadcast against ``(N, width)`` rows, or in an ensemble, whose
    leaves carry a leading member axis, against ``(K, N, width)``."""
    return t if t.dim() <= 1 else t.unsqueeze(-2)


def _dense_taps(layer, V, taps, closure):
    """Taylor state through a dense layer: one stacked matmul moves the
    value and every tap; the bias lands on the value only.  Rows stack on
    the second-to-last axis, so an ensemble's ``(K, in, out)`` weights
    take shared ``(N, in)`` points or ``(K, N, in)`` states alike."""
    blocks = [V] + [taps[mi] for mi in closure]
    out = torch.cat(blocks, dim=-2) @ layer["w"]
    n = V.shape[-2]
    # Slices by count, not torch.split: the count of parts stays known
    # when the batch is symbolic (torch.export).
    parts = [out.narrow(-2, i * n, n) for i in range(len(blocks))]
    return (parts[0] + _feature(layer["b"]),
            {mi: parts[1 + i] for i, mi in enumerate(closure)})


def _concat(a, b):
    """Feature concatenation of two states, a shared ``(N, w)`` one
    expanded to an ensemble's ``(K, N, w)``."""
    if a.dim() < b.dim():
        a = a.expand(b.shape[:-1] + a.shape[-1:])
    elif b.dim() < a.dim():
        b = b.expand(a.shape[:-1] + b.shape[-1:])
    return torch.cat([a, b], dim=-1)


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


def _initial_state(x, closure, init):
    """The traversal's input state: ``init`` = ``(V, {multi-index: tap})``
    (missing taps are zero), or the identity state of ``x``."""
    if init is None:
        return _identity_state(x, closure)
    V, taps = init
    return V, {mi: taps[mi] if mi in taps else torch.zeros_like(V)
               for mi in closure}


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


def _is_elementwise(act):
    """Whether an activation acts elementwise (a diagonal Jacobian, which
    the Taylor traversal's chain rule needs): one eager probe on CPU
    tensors, ``J·u == (J·1) * u`` for a tangent ``u``, cached per
    activation object while it lives.  A callable that fails the probe,
    or that cannot be weakly referenced (a builtin), is probed again at
    every build."""
    try:
        return _ELEMENTWISE_CACHE[act]
    except (KeyError, TypeError):
        pass
    x = torch.linspace(-1.2, 1.1, 6).reshape(2, 3)
    u = torch.linspace(0.3, 2.1, 6).reshape(2, 3)
    try:
        y, ju = torch.func.jvp(act, (x,), (u,))
        _, j1 = torch.func.jvp(act, (x,), (torch.ones_like(x),))
        verdict = (tuple(y.shape) == tuple(x.shape)
                   and bool(torch.allclose(ju, j1 * u, rtol=1e-4,
                                           atol=1e-5)))
    except Exception:   # pylint: disable=broad-except
        return False
    try:
        _ELEMENTWISE_CACHE[act] = verdict
    except TypeError:
        pass
    return verdict


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
    """Parse a layout string into a token list; validates the characters
    and the balance of branch starts and joins."""
    tokens = [ch for ch in layout if ch != " "]
    for ch in tokens:
        if ch not in ("f", "c", "a", "R", "B", "n", *_JOINS):
            raise ValueError(
                f"unknown layout token {ch!r} in layout {layout!r}; "
                "supported tokens: 'f' (dense), 'c' (conv, dense on point "
                "clouds), 'a' (activation), 'n' (LayerNorm), 'R' (skip "
                "start), 'B' (branch start), '+'/'*'/'.' (join by "
                "sum/product/concat)")
    depth = 0
    for ch in tokens:
        if ch in ("R", "B"):
            depth += 1
        elif ch in _JOINS:
            depth -= 1
            if depth < 0:
                raise ValueError(
                    f"layout {layout!r}: join {ch!r} with no matching 'R' "
                    "or 'B' branch start")
    if depth != 0:
        raise ValueError(
            f"layout {layout!r}: unmatched 'R'/'B' branch start")
    return tokens


def _resolve_activations(activation, n_act, layout):
    """One resolved activation per ``a`` slot."""
    if isinstance(activation, (list, tuple)):
        if len(activation) == n_act:
            return [resolve_activation(a) for a in activation]
        if len(activation) == 1:
            return [resolve_activation(activation[0])] * n_act
        raise ValueError(
            f"layout {layout!r} has {n_act} activation slots but "
            f"activation sequence has {len(activation)} entries")
    return [resolve_activation(activation)] * n_act


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
        bound = 1.0 / math.sqrt(self.w.shape[-2])
        with torch.no_grad():
            for p in (self.w, self.b):
                draw = torch.rand(p.shape, generator=generator,
                                  dtype=p.dtype)
                p.copy_(draw * (2 * bound) - bound)

    def params(self):
        return {"w": self.w, "b": self.b}


class _Leaves(nn.Module):
    """A layer of named parameter leaves with constant initial values:
    LayerNorm's ``g`` and ``b``, a LAAF slope's ``a``."""

    def __init__(self, inits, dtype, device):
        super().__init__()
        self._inits = inits
        for name, (shape, _) in inits.items():
            setattr(self, name, nn.Parameter(torch.empty(
                shape, dtype=dtype, device=device)))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for name, (_, value) in self._inits.items():
                getattr(self, name).fill_(value)

    def params(self):
        return {name: getattr(self, name) for name in self._inits}


def _dense(layer, h):
    return h @ layer["w"] + _feature(layer["b"])


def _branch_params(params, index):
    """The ``br{index+1}_``-prefixed slice of ``params``, un-prefixed for
    the branch sub-network."""
    prefix = f"br{index + 1}_"
    return {nm[len(prefix):]: v for nm, v in params.items()
            if nm.startswith(prefix)}


class LayoutNetwork(nn.Module):
    """A layout-string network: dense layers ``fc1``, ``fc2``, ... (1-based,
    as the reference's ``freeze_layers(['fc1', ...])`` names them), then
    LayerNorms ``ln{i}``, LAAF slopes ``aa{i}`` and the branches' layers
    ``br{i}_...``, in the order of ``pydens_tpu``'s ``layer_names``."""

    def __init__(self, layout, features, activation, in_dim,
                 dtype=torch.float32, device=None, branches=None,
                 adaptive_activation=None):
        super().__init__()
        tokens = parse_layout(layout)
        aa_scale = None
        if adaptive_activation is not None:
            aa_scale = float(adaptive_activation)
            if not aa_scale > 0:
                raise ValueError(
                    f"adaptive_activation={adaptive_activation!r} must be a "
                    "positive scale factor n (slopes train as sigma(n*a*h), "
                    "a init 1/n); typical n: 5-10")
        n_branch_slots = sum(1 for t in tokens if t == "B")
        branches = list(branches or [])
        if len(branches) > n_branch_slots:
            raise ValueError(
                f"layout {layout!r} has {n_branch_slots} 'B' branch starts "
                f"but branches= has {len(branches)} entries")
        branches += [None] * (n_branch_slots - len(branches))
        n_dense = sum(1 for t in tokens if t in ("f", "c"))
        n_act = sum(1 for t in tokens if t == "a")
        features = list(features)
        if len(features) != n_dense:
            raise ValueError(
                f"layout {layout!r} has {n_dense} dense layers but "
                f"features/units has {len(features)} entries")
        acts = _resolve_activations(activation, n_act, layout)

        # Symbolic pass: per-layer input widths, LayerNorm widths, branch
        # sub-networks (their in_dim is the width at their branch point)
        # and the join widths.
        in_dims, ln_dims, subs, stack = [], [], [], []
        cur, di, bi = in_dim, 0, 0
        for tok in tokens:
            if tok in ("f", "c"):
                in_dims.append(cur)
                cur = features[di]
                di += 1
            elif tok == "n":
                ln_dims.append(cur)
            elif tok == "R":
                stack.append(cur)
            elif tok == "B":
                sub = self._branch(branches[bi], bi, activation, cur, dtype,
                                   device, adaptive_activation)
                subs.append(sub)
                # The branch's true output width, which a trailing join of
                # its own may change after its last dense layer.
                stack.append(cur if sub is None else sub.out_dim)
                bi += 1
            elif tok in ("+", "*"):
                skip = stack.pop()
                if skip != cur:
                    kind = ("skip connection" if tok == "+"
                            else "elementwise product join")
                    raise ValueError(
                        f"layout {layout!r}: {kind} joins width {skip} "
                        f"with width {cur}; sum-skips and product joins "
                        "require equal widths")
            elif tok == ".":
                cur = cur + stack.pop()

        self.layout = layout
        self.tokens = tokens
        self.activations = acts
        self.in_dim = in_dim
        self.out_dim = cur
        self.aa_scale = aa_scale
        self.dense_names = [f"fc{i + 1}" for i in range(n_dense)]
        self.ln_names = [f"ln{j + 1}" for j in range(len(ln_dims))]
        self.aa_names = ([f"aa{j + 1}" for j in range(n_act)]
                         if aa_scale is not None else [])
        self.layer_shapes = list(zip(in_dims, features))
        self.branch_nets = nn.ModuleDict({
            f"br{i + 1}": sub for i, sub in enumerate(subs)
            if sub is not None})
        self._subs = subs
        self.layer_names = (
            self.dense_names + self.ln_names + self.aa_names
            + [f"br{i + 1}_{nm}" for i, sub in enumerate(subs)
               if sub is not None for nm in sub.layer_names])
        # True only where a slope exists (this chain or a branch).
        self.adaptive = bool(self.aa_names) or any(
            sub is not None and sub.adaptive for sub in subs)
        # The Taylor traversal reads σ', σ'', ... as J·1: elementwise
        # activations only; LayerNorm mixes features.
        self.taylor_ok = (all(_is_elementwise(a) for a in set(acts))
                          and "n" not in tokens
                          and all(sub is None or sub.taylor_ok
                                  for sub in subs))
        self.layers = nn.ModuleDict({
            name: Dense(fan_in, fan_out, dtype, device)
            for name, (fan_in, fan_out) in zip(self.dense_names,
                                               self.layer_shapes)})
        self.norms = nn.ModuleDict({
            name: _Leaves({"g": ((width,), 1.0), "b": ((width,), 0.0)},
                          dtype, device)
            for name, width in zip(self.ln_names, ln_dims)})
        self.slopes = nn.ModuleDict({
            name: _Leaves({"a": ((1,), 1.0 / aa_scale)}, dtype, device)
            for name in self.aa_names})

    @staticmethod
    def _branch(spec, index, activation, width, dtype, device,
                adaptive_activation):
        """The sub-network of the ``index``-th ``B`` (None: identity)."""
        if spec is None:
            return None
        keys = sorted(dict(spec))
        spec = dict(spec)
        try:
            layout = spec.pop("layout")
            features = list(spec.pop("features"))
        except KeyError as exc:
            raise ValueError(
                f"branch spec for 'B' #{index + 1} needs 'layout' and "
                f"'features' keys; got {keys}") from exc
        b_act = spec.pop("activation", activation)
        b_branches = spec.pop("branches", None)
        if spec:
            raise ValueError(
                f"unknown branch spec key(s) {sorted(spec)} for 'B' "
                f"#{index + 1}; known: layout, features, activation, "
                "branches")
        return LayoutNetwork(layout, features, b_act, width, dtype=dtype,
                             device=device, branches=b_branches,
                             adaptive_activation=adaptive_activation)

    def reset_parameters(self, generator):
        """Dense layers U(+-1/sqrt(fan_in)) drawn from ``generator``, then
        LayerNorm scales 1 and biases 0, slopes ``1/n``, then each branch
        from the same generator."""
        for name in self.dense_names:
            self.layers[name].reset_parameters(generator)
        for module in list(self.norms.values()) + list(self.slopes.values()):
            module.reset_parameters()
        for sub in self.branch_nets.values():
            sub.reset_parameters(generator)

    def params(self):
        """The live parameters as a ``{name: {leaf: tensor}}`` dict."""
        out = {name: self.layers[name].params() for name in self.dense_names}
        out.update({name: self.norms[name].params()
                    for name in self.ln_names})
        out.update({name: self.slopes[name].params()
                    for name in self.aa_names})
        for key, sub in self.branch_nets.items():
            out.update({f"{key}_{nm}": v for nm, v in sub.params().items()})
        return out

    def _slope(self, params, ai):
        return self.aa_scale * _feature(params[self.aa_names[ai]]["a"])

    def apply(self, params, x):
        """Apply the network to a ``(N, in_dim)`` batch of points; with an
        ensemble's parameters (a leading member axis ``K`` on every leaf)
        to shared ``(N, in_dim)`` or per-member ``(K, N, in_dim)`` points,
        giving ``(K, N, out_dim)``."""
        h = x
        stack = []
        di = ai = li = bi = 0
        for tok in self.tokens:
            if tok in ("f", "c"):
                h = _dense(params[self.dense_names[di]], h)
                di += 1
            elif tok == "a":
                if self.aa_names:
                    h = h * self._slope(params, ai)
                h = self.activations[ai](h)
                ai += 1
            elif tok == "n":
                layer = params[self.ln_names[li]]
                mu = h.mean(dim=-1, keepdim=True)
                var = torch.square(h - mu).mean(dim=-1, keepdim=True)
                h = _feature(layer["g"]) * (h - mu) * torch.rsqrt(
                    var + 1e-6) + _feature(layer["b"])
                li += 1
            elif tok == "R":
                stack.append(h)
            elif tok == "B":
                sub = self._subs[bi]
                stack.append(h if sub is None
                             else sub.apply(_branch_params(params, bi), h))
                bi += 1
            elif tok == "+":
                h = h + stack.pop()
            elif tok == "*":
                h = h * stack.pop()
            elif tok == ".":
                h = _concat(h, stack.pop())
        return h

    def forward(self, x):
        return self.apply(self.params(), x)

    def taylor_taps(self, params, x, closure, init=None):
        """Single-traversal Taylor-mode propagation: the network value plus
        every directional-derivative tap in ``closure`` (downward-closed
        sorted multi-indices over input columns), in ONE pass with
        batched-tangent matmuls.  ``init`` is the input state ``(V, {multi-
        index: tap})`` when the network reads a transform of the
        coordinates (an embedding); by default the identity.  A LAAF slope
        scales the value and every tap alike; branches recurse from the
        state at their branch point; a product join takes the Leibniz
        rule.  Returns ``(V, {multi-index: tap})``."""
        closure = [tuple(mi) for mi in closure]
        _validate_closure(closure)
        V, taps = _initial_state(x, closure, init)
        max_order = max((len(mi) for mi in closure), default=0)
        stack = []
        di = ai = bi = 0
        for tok in self.tokens:
            if tok in ("f", "c"):
                V, taps = _dense_taps(params[self.dense_names[di]], V, taps,
                                      closure)
                di += 1
            elif tok == "a":
                if self.aa_names:
                    s = self._slope(params, ai)
                    V = V * s
                    taps = {mi: t * s for mi, t in taps.items()}
                V, taps = _act_taps(self.activations[ai], V, taps, closure,
                                    max_order)
                ai += 1
            elif tok == "n":
                raise ValueError(
                    "the Taylor fast path does not support LayerNorm 'n' "
                    "(non-diagonal Jacobian); use the nested-jvp fallback")
            elif tok == "R":
                stack.append((V, dict(taps)))
            elif tok == "B":
                sub = self._subs[bi]
                stack.append((V, dict(taps)) if sub is None else
                              sub.taylor_taps(_branch_params(params, bi), V,
                                              closure, init=(V, dict(taps))))
                bi += 1
            elif tok == "+":
                V0, taps0 = stack.pop()
                V = V + V0
                taps = {mi: taps[mi] + taps0[mi] for mi in closure}
            elif tok == "*":
                V0, taps0 = stack.pop()
                V, taps = _product_taps(V, taps, V0, taps0, closure)
            elif tok == ".":
                V0, taps0 = stack.pop()
                V = _concat(V, V0)
                taps = {mi: _concat(taps[mi], taps0[mi]) for mi in closure}
        return V, taps


def make_layout_network(layout, features, activation, in_dim,
                        dtype=torch.float32, device=None, branches=None,
                        adaptive_activation=None):
    """Build a :class:`LayoutNetwork` (parameters uninitialized until
    :meth:`LayoutNetwork.reset_parameters`)."""
    return LayoutNetwork(layout, features, activation, in_dim, dtype=dtype,
                         device=device, branches=branches,
                         adaptive_activation=adaptive_activation)


class ModifiedMLPNetwork(nn.Module):
    """The Wang–Sankaran–Perdikaris modified MLP (arXiv:2001.04536 §3),
    counterpart of ``pydens_tpu``'s ``make_modified_mlp_network``:

        U = σ(x Wᵤ + bᵤ),   W = σ(x W_w + b_w),   h₀ = x
        hₖ = U + zₖ·(W − U),   zₖ = σ(hₖ₋₁ Wₖ + bₖ)
        out = h_L W_out + b_out

    ``features`` is ``[w, ..., w, out]`` (every hidden layer width ``w``,
    ``len(features) - 1`` gates), one activation for every σ.  Layers
    ``fcu``, ``fcw`` (encoders), ``fc1..fcL`` (gates), ``fc{L+1}``
    (output).  The gates run as a Python loop (under a CUDA graph the
    loop costs nothing at run time)."""

    tokens = None   # not a layout chain: no fused kernel applies
    adaptive = False

    def __init__(self, features, activation, in_dim, dtype=torch.float32,
                 device=None):
        super().__init__()
        features = list(features)
        if len(features) < 2:
            raise ValueError("modified MLP needs at least [width, out] in "
                             "features")
        hidden, out_dim = features[:-1], features[-1]
        if len(set(hidden)) != 1:
            raise ValueError(
                f"modified MLP requires equal hidden widths (the gate mixes "
                f"every layer with the shared U/W encoder streams); got "
                f"features={features} — use e.g. [{hidden[0]}]*{len(hidden)} "
                f"+ [{out_dim}]")
        width = hidden[0]
        self.n_gates = len(hidden)
        if isinstance(activation, (list, tuple)):
            if len(set(map(str, activation))) != 1:
                raise ValueError("modified MLP uses one activation for every "
                                 "σ slot; pass a single spec")
            activation = activation[0]
        self.act = resolve_activation(activation)
        self.activations = [self.act]
        self.taylor_ok = _is_elementwise(self.act)
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.layer_names = (["fcu", "fcw"]
                            + [f"fc{i + 1}" for i in range(self.n_gates + 1)])
        self.layer_shapes = ([(in_dim, width), (in_dim, width)]
                             + [(in_dim if i == 0 else width, width)
                                for i in range(self.n_gates)]
                             + [(width, out_dim)])
        self.layers = nn.ModuleDict({
            name: Dense(fan_in, fan_out, dtype, device)
            for name, (fan_in, fan_out) in zip(self.layer_names,
                                               self.layer_shapes)})

    def reset_parameters(self, generator):
        for name in self.layer_names:
            self.layers[name].reset_parameters(generator)

    def params(self):
        return {name: self.layers[name].params() for name in self.layer_names}

    def forward(self, x):
        return self.apply(self.params(), x)

    def apply(self, params, x):
        act = self.act
        U = act(_dense(params["fcu"], x))
        W = act(_dense(params["fcw"], x))
        h = x
        for i in range(self.n_gates):
            z = act(_dense(params[f"fc{i + 1}"], h))
            h = U + z * (W - U)   # == (1 - z)·U + z·W
        return _dense(params[f"fc{self.n_gates + 1}"], h)

    def taylor_taps(self, params, x, closure, init=None):
        """The Taylor traversal through the gated net: dense and activation
        steps as in :class:`LayoutNetwork`, the gate mix ``U + z·(W − U)``
        by the Leibniz rule.  Same contract as
        :meth:`LayoutNetwork.taylor_taps`."""
        closure = [tuple(mi) for mi in closure]
        _validate_closure(closure)
        V, taps = _initial_state(x, closure, init)
        max_order = max((len(mi) for mi in closure), default=0)

        def through(name, state):
            return _act_taps(self.act, *_dense_taps(params[name], *state,
                                                    closure),
                             closure, max_order)

        U = through("fcu", (V, taps))
        W = through("fcw", (V, taps))
        diff = (W[0] - U[0], {mi: W[1][mi] - U[1][mi] for mi in closure})
        h = (V, taps)
        for i in range(self.n_gates):
            zv, zt = through(f"fc{i + 1}", h)
            pv, pt = _product_taps(zv, zt, diff[0], diff[1], closure)
            h = (U[0] + pv, {mi: U[1][mi] + pt[mi] for mi in closure})
        return _dense_taps(params[f"fc{self.n_gates + 1}"], *h, closure)


def make_modified_mlp_network(features, activation, in_dim,
                              dtype=torch.float32, device=None):
    """Build a :class:`ModifiedMLPNetwork` (parameters uninitialized until
    :meth:`ModifiedMLPNetwork.reset_parameters`)."""
    return ModifiedMLPNetwork(features, activation, in_dim, dtype=dtype,
                              device=device)
