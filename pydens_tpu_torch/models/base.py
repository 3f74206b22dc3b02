"""Model base class and the default layout-built model, in PyTorch.

Counterpart of ``pydens_tpu/models/base.py``.  A model is an ``nn.Module``
holding its parameters — the network's ``fc{i}`` layers, the trainable
``log_scale`` of the time gate and the ``V``-token ``variables`` — and
functional entry points that take an explicit parameter tree

``{'net': {'fc1': {'w', 'b'}, ...}, 'log_scale': scalar,
   'variables': {name: tensor, ...}}``

(:attr:`Model.params` returns the live one), so the Solver can train views
into one flat parameter vector.  The ansatz binding boundary and initial
conditions exactly is the reference's (``model_torch.py:107-128``).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from torch import nn

from .layout import make_layout_network
from ..ops.tokens import _batch_diagonal_grad, variable_scope
from ..ops import fused_mlp, fused_taylor

__all__ = ["Model", "ConvBlockModel", "TorchModel", "resolve_device"]

# Keyword arguments of the JAX models that this package does not take yet
# (ROADMAP.md, Queue 1 item 11).
_NOT_PORTED = ("periodic", "fourier_features", "arch", "branches",
               "adaptive_activation", "initial_condition_t",
               "periodic_ic_decay")


def resolve_device(device=None):
    """``device`` as a ``torch.device``.  None means the CUDA card: without
    one it raises, and the CPU is taken only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pydens_tpu_torch runs on the card by "
                "default; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def _normalize_domain(domain, ndims):
    """A ``(lo, hi)`` pair is tiled over all dims; a per-dim sequence of
    pairs passes through (``model_torch.py:37-46``)."""
    if isinstance(domain, (tuple, list)) and len(domain) > 0:
        if isinstance(domain[0], (float, int)):
            domain = [tuple(domain)] * ndims
        elif isinstance(domain[0], (tuple, list)):
            domain = [tuple(d) for d in domain]
        else:
            raise ValueError(
                "domain should be either 1d or 2d-sequence of float/ints.")
    else:
        raise ValueError(
            "domain should be either 1d or 2d-sequence of float/ints.")
    if len(domain) != ndims:
        raise ValueError(
            f"domain has {len(domain)} (lo, hi) pairs but ndims={ndims}")
    return domain


def _normalize_ic_shape(ic, n_points, n_out):
    """Shape a condition value to broadcast against ``(n_points, n_out)``:
    scalar; ``(n_points,)`` per point; ``(n_out,)`` per component; or an
    already broadcast-compatible 2-D shape."""
    if ic.ndim == 0:
        return ic.reshape(1, 1)
    if ic.ndim == 1:
        if ic.shape[0] == n_points:
            return ic.reshape(-1, 1)
        if ic.shape[0] == n_out:
            return ic.reshape(1, -1)
        if ic.shape[0] == 1:
            return ic.reshape(1, 1)
        raise ValueError(
            f"initial_condition returned shape {tuple(ic.shape)}, which "
            f"matches neither the batch ({n_points} points) nor the number "
            f"of solution components ({n_out})")
    if ic.ndim == 2:
        rows, cols = ic.shape
        if rows in (1, n_points) and cols in (1, n_out):
            return ic
        raise ValueError(
            f"initial_condition returned shape {tuple(ic.shape)}, which "
            f"cannot broadcast against the ({n_points}, {n_out}) network "
            "output")
    raise ValueError(
        f"initial_condition returned a rank-{ic.ndim} tensor; expected "
        "scalar, 1-D, or 2-D")


def _tree_fill(tree, value):
    """The dict structure of ``tree`` with every leaf replaced by
    ``value``."""
    if isinstance(tree, dict):
        return {k: _tree_fill(v, value) for k, v in tree.items()}
    return value


class Model(nn.Module):
    """Base model: problem dimensionality, condition parsing, the ansatz and
    the Taylor-plan tap table.  Subclasses provide the network body:
    :meth:`reset_parameters`, :meth:`network_params` and
    :meth:`network_apply` (and may provide ``network_apply_taylor``)."""

    def __init__(self, ndims, initial_condition=None, boundary_condition=None,
                 domain=(0, 1), nparams=0, dtype=torch.float32, device=None,
                 **kwargs):
        super().__init__()
        not_ported = sorted(set(kwargs) & set(_NOT_PORTED))
        if not_ported:
            raise NotImplementedError(
                f"{not_ported} not ported to pydens_tpu_torch yet "
                "(ROADMAP.md, Queue 1 item 11)")
        if kwargs:
            raise ValueError(
                f"{type(self).__name__} got unknown keyword argument(s) "
                f"{sorted(kwargs)} — check the spelling against the model's "
                "constructor (layout/features/units/activation/dtype/...)")
        self.ndims = ndims
        self.ndims_spatial = ndims if initial_condition is None else ndims - 1
        self.nparams = nparams
        self.total = ndims + nparams
        self.dtype = dtype
        self.device = resolve_device(device)

        if initial_condition is None or callable(initial_condition):
            self.initial_condition = initial_condition
        else:
            ic_value = np.asarray(
                initial_condition.detach().cpu().numpy()
                if hasattr(initial_condition, "detach")
                else initial_condition, dtype=np.float32)
            if ic_value.ndim > 1:
                raise ValueError(
                    "a non-callable initial_condition must be a scalar or a "
                    f"1-D per-component vector; got shape {ic_value.shape}")
            if ic_value.ndim == 1 and ic_value.shape[0] > 1:
                ic_value = ic_value.reshape(1, -1)
            ic_tensor = torch.as_tensor(ic_value, dtype=dtype,
                                        device=self.device)
            self.initial_condition = lambda *cols: ic_tensor
        self.boundary_condition = boundary_condition
        self.domain = _normalize_domain(domain, ndims)

        self.log_scale = nn.Parameter(
            torch.zeros((), dtype=dtype, device=self.device))
        self.variables = nn.ParameterDict()
        # Interpretation of 1-D callable condition outputs, frozen at the
        # Solver's one-row discovery run ('per_point' | 'per_component').
        self._cond_modes = {}
        self._frozen_layers = set()
        self._frozen_variables = set()
        # False until the Solver's discovery run has created the V
        # variables: names frozen before then are validated lazily.
        self._params_ready = False

    # -- network body (provided by subclasses) ------------------------------
    def reset_parameters(self, generator):
        raise NotImplementedError

    def network_params(self):
        raise NotImplementedError

    def network_apply(self, net_params, xs):
        raise NotImplementedError

    network_apply_taylor = None  # set by models that support the plan

    def network_apply_predict(self, net_params, xs):
        """Network forward used by :meth:`predict_apply`."""
        return self.network_apply(net_params, xs)

    # -- parameters ---------------------------------------------------------
    @property
    def params(self):
        """The live parameter tree (``nn.Parameter`` leaves)."""
        return {"net": self.network_params(), "log_scale": self.log_scale,
                "variables": dict(self.variables.items())}

    def set_variables(self, values):
        """Create the ``V``-token variables from their initial values."""
        for name, value in values.items():
            self.variables[name] = nn.Parameter(torch.as_tensor(
                np.asarray(value), dtype=self.dtype, device=self.device))
        self._params_ready = True

    def trainable_mask(self, params):
        """Boolean tree matching ``params``: True where trainable.

        Frozen layers are addressed by name (``fc1``..., or ``conv_block`` /
        ``net`` for the whole body); frozen variables by name (``log_scale``
        or any V-token variable), a name also freezing every variable it
        prefixes as ``name.``.  Names frozen before the parameters existed
        are validated here: a misspelled name raises instead of being
        ignored.
        """
        unknown_layers = (self._frozen_layers - set(params["net"])
                          - {"conv_block", "net"})
        if unknown_layers:
            raise AttributeError(
                f"unknown frozen layer(s) {sorted(unknown_layers)}; known "
                f"layers: {sorted(params['net'])} (or 'conv_block' for the "
                "whole network body)")
        known_vars = set(params["variables"]) | {"log_scale"}
        unknown_vars = {
            v for v in self._frozen_variables
            if v not in known_vars
            and not any(k.startswith(v + ".") for k in known_vars)}
        if unknown_vars:
            raise AttributeError(
                f"unknown frozen variable(s) {sorted(unknown_vars)}; known: "
                f"{sorted(known_vars)}")
        freeze_all_net = bool({"conv_block", "net"} & self._frozen_layers)

        def layer_mask(name, subtree):
            trainable = not (freeze_all_net or name in self._frozen_layers)
            return _tree_fill(subtree, trainable)

        return {
            "net": {name: layer_mask(name, sub)
                    for name, sub in params["net"].items()},
            "log_scale": "log_scale" not in self._frozen_variables,
            "variables": {
                name: (name not in self._frozen_variables
                       and not any(name.startswith(fz + ".")
                                   for fz in self._frozen_variables))
                for name in params["variables"]},
        }

    def _validate_freeze_names(self, layers, variables):
        """Unknown names are an error, as in the reference (its ``getattr``
        lookups raise AttributeError, ``model_torch.py:76,81``)."""
        if not self._params_ready:
            return  # pre-init freeze; validated lazily by trainable_mask
        params = self.params
        known_layers = set(params["net"]) | {"conv_block", "net"}
        for name in layers:
            if name not in known_layers:
                raise AttributeError(
                    f"unknown layer {name!r}; known layers: "
                    f"{sorted(params['net'])} (or 'conv_block' for the "
                    "whole network body)")
        known_vars = set(params["variables"]) | {"log_scale"}
        for name in variables:
            if (name not in known_vars
                    and not any(k.startswith(name + ".")
                                for k in known_vars)):
                raise AttributeError(
                    f"unknown trainable variable {name!r}; known: "
                    f"{sorted(known_vars)} (a Field freezes by prefix)")

    # -- freeze / unfreeze (reference API: model_torch.py:56-105) ----------
    def freeze_trainable(self, layers=None, variables=None):
        """Freeze layers (by name) and trainable variables, as in the
        reference's two-phase inverse-problem training.  The Solver masks
        their gradient entries to zero before the optimizer."""
        layers = list(layers or [])
        variables = list(variables or [])
        self._validate_freeze_names(layers, variables)
        self._frozen_layers |= set(layers)
        self._frozen_variables |= set(variables)

    def unfreeze_trainable(self, layers=None, variables=None):
        """Reverse :meth:`freeze_trainable`."""
        layers = list(layers or [])
        variables = list(variables or [])
        self._validate_freeze_names(layers, variables)
        self._frozen_layers -= set(layers)
        self._frozen_variables -= set(variables)

    # The reference README and examples use these names (v1.0.2 ships
    # freeze_trainable); both work.
    freeze_layers = freeze_trainable
    unfreeze_layers = unfreeze_trainable

    def load_params(self, params):
        """Copy a parameter tree (same structure as :attr:`params`) into
        the model's parameters."""
        def copy(dst, src):
            if isinstance(dst, dict):
                for key in dst:
                    copy(dst[key], src[key])
            else:
                dst.copy_(torch.as_tensor(src).reshape(dst.shape))
        with torch.no_grad():
            copy(self.params, params)

    # -- forward + ansatz ---------------------------------------------------
    def apply(self, params, xs):
        """Full forward: network body then ansatz. ``xs`` is ``(N, total)``."""
        return self.anzatc(self.network_apply(params["net"], xs), xs, params)

    def apply_leaves(self, params, leaves):
        """Equation-path forward on the per-coordinate leaf columns."""
        return self.apply(params, torch.cat(leaves, dim=1))

    def _normalize_cond(self, key, val, n_points, n_out):
        if val.ndim != 1:
            return _normalize_ic_shape(val, n_points, n_out)
        mode = self._cond_modes.get(key)
        if mode is None:
            out = _normalize_ic_shape(val, n_points, n_out)
            self._cond_modes[key] = ("per_point" if out.shape[1] == 1
                                     else "per_component")
            return out
        if mode == "per_component":
            if val.shape[0] != n_out:
                raise ValueError(
                    f"{key} returned shape {tuple(val.shape)}; expected one "
                    f"value per solution component ({n_out})")
            return val.reshape(1, -1)
        if val.shape[0] not in (n_points, 1):
            raise ValueError(
                f"{key} returned shape {tuple(val.shape)}; expected one "
                f"value per point ({n_points})")
        return val.reshape(-1, 1)

    def anzatc(self, u, xs, params):
        """Ansatz binding boundary/initial conditions exactly
        (``model_torch.py:107-128``):

        * BC: ``u * prod((x-lo)(hi-x)/(hi-lo)^2) + bc`` over the spatial
          dims — the polynomial vanishes on the whole boundary;
        * IC: ``(sigmoid((t-t0)/exp(log_scale)) - 0.5) * u + ic(x_spatial)``
          with ``t`` the last variable column and ``t0`` its lower bound.

        Parameter columns (``nparams``) never enter the ansatz.
        """
        nds = self.ndims_spatial
        xs_spatial = xs[:, :nds]
        t = xs[:, self.ndims - 1:self.ndims]
        lower = [float(lims[0]) for lims in self.domain]
        upper = [float(lims[1]) for lims in self.domain]
        t0 = lower[-1]

        if self.boundary_condition is not None:
            shape_fn = torch.ones_like(u)
            for i in range(nds):
                xi = xs_spatial[:, i:i + 1]
                lo_i, hi_i = lower[i], upper[i]
                inv_span2 = 1.0 / ((hi_i - lo_i) * (hi_i - lo_i))
                shape_fn = shape_fn * ((xi - lo_i) * (hi_i - xi) * inv_span2)
            bc = self.boundary_condition
            if callable(bc):
                bc = torch.as_tensor(
                    bc(*[xs_spatial[:, i] for i in range(nds)]),
                    dtype=self.dtype, device=u.device)
                bc = self._normalize_cond("boundary_condition", bc,
                                          u.shape[0], u.shape[1])
            u = u * shape_fn + bc

        if self.initial_condition is not None:
            cols = [xs_spatial[:, i] for i in range(nds)]
            ic = torch.as_tensor(self.initial_condition(*cols),
                                 dtype=self.dtype, device=u.device)
            ic = self._normalize_cond("initial_condition", ic,
                                      u.shape[0], u.shape[1])
            gate = torch.sigmoid(
                (t - t0) / torch.exp(params["log_scale"])) - 0.5
            u = gate * u + ic
        return u

    # -- Taylor-mode derivative taps (planned fast path) ---------------------
    @staticmethod
    def plan_closure(derivs):
        """Downward-closed derivative set for one Taylor traversal: every
        sub-multi-index of every requested derivative, sorted by
        (order, index)."""
        closure = set()

        def add(mi):
            if not mi or mi in closure:
                return
            closure.add(mi)
            for i in range(len(mi)):
                add(mi[:i] + mi[i + 1:])

        for d in derivs:
            add(tuple(sorted(d)))
        return sorted(closure, key=lambda m: (len(m), m))

    @property
    def supports_taylor(self):
        return self.network_apply_taylor is not None

    def full_taps(self, params, xs, derivs):
        """All requested pure field taps of the FULL model (network body +
        ansatz) in one Taylor-mode network traversal.

        The network propagates batched tangents (``network_apply_taylor``);
        the ansatz composes exactly through a polarized scalar substitution:
        with one scalar per position of the multi-index ``p`` and the
        network's multilinear expansion

            ``net(s_0..s_{m-1}) = V + sum over nonempty position subsets B
            of (prod_{i in B} s_i) * tap[sorted(p[B])]``,

        the mixed partial ``d^m/(ds_0..ds_{m-1})`` of
        ``anzatc(net(s), xs + sum_i s_i e_{p_i})`` at 0 is exactly the
        composite's derivative.  The scalars are per-row ``(N, 1)`` leaves
        and each partial is one ``torch.autograd.grad`` of the row sum
        (rows are independent — the batch-diagonal rule ``D`` uses), with
        the graph kept for the parameter gradient.  Nested
        ``torch.func.jvp`` computes the same numbers at several times the
        host cost per step.  Returns ``{multi-index: (N, n_out)}``,
        including ``()``.
        """
        closure = self.plan_closure(derivs)
        V, taps = self.network_apply_taylor(params["net"], xs, closure)
        table = {(): self.anzatc(V, xs, params)}
        n, n_total = xs.shape
        for mi in sorted({tuple(sorted(d)) for d in derivs},
                         key=lambda m: (len(m), m)):
            m = len(mi)
            svec = [xs.new_zeros((n, 1)).requires_grad_(True)
                    for _ in range(m)]
            net = V
            for r in range(1, m + 1):
                for B in itertools.combinations(range(m), r):
                    coef = svec[B[0]]
                    for i in B[1:]:
                        coef = coef * svec[i]
                    net = net + coef * taps[tuple(sorted(mi[i] for i in B))]
            shift = xs
            for i in range(m):
                e = xs.new_zeros((n_total,))
                e[mi[i]] = 1.0
                shift = shift + svec[i] * e
            out = self.anzatc(net, shift, params)
            for s in svec:
                out = _batch_diagonal_grad(out, s)
            table[mi] = out
        return table

    # -- inference ----------------------------------------------------------
    def predict_apply(self, params, xs):
        """Inference entry on a device tensor ``(N, total)``: the network
        through :meth:`network_apply_predict` (the fused MLP kernel on CUDA
        where the layout is in its scope), then the ansatz."""
        with torch.no_grad(), variable_scope("read", params["variables"]):
            u = self.network_apply_predict(params["net"], xs)
            return self.anzatc(u, xs, params)


class ConvBlockModel(Model):
    """Default model: network body built from the layout-string DSL.

    Mirrors ``ConvBlockModel`` (``model_torch.py:130-172``): defaults
    ``layout='fafaf'``, ``features=(20, 30, 1)``, ``activation='Sigmoid'``;
    accepts the ``units`` spelling for ``features``.
    """

    def __init__(self, ndims, initial_condition=None, boundary_condition=None,
                 domain=(0, 1), nparams=0, layout="fafaf",
                 features=(20, 30, 1), activation="Sigmoid", units=None,
                 dtype=torch.float32, device=None, **kwargs):
        super().__init__(ndims=ndims, initial_condition=initial_condition,
                         boundary_condition=boundary_condition, domain=domain,
                         nparams=nparams, dtype=dtype, device=device,
                         **kwargs)
        if units is not None:
            features = units
        self.layout = layout
        self.features = list(features)
        self.activation = activation
        self.net = make_layout_network(layout, self.features, activation,
                                       in_dim=self.total, dtype=dtype,
                                       device=self.device)
        self.layer_names = self.net.layer_names
        self._taylor_plans = {}
        self._mlp_plan = None
        if fused_mlp.supports(self.net.tokens, self.net.activations,
                              self.net.layer_shapes, self.total, dtype):
            self._mlp_plan = fused_mlp.MlpPlan(
                self.net.tokens, self.net.activations, self.net.layer_shapes,
                self.total)
        if not self.net.taylor_ok:
            # A callable activation that is not known to act elementwise:
            # no Taylor plan, derivatives take the nested-gradient path.
            self.network_apply_taylor = None

    def reset_parameters(self, generator):
        self.net.reset_parameters(generator)
        with torch.no_grad():
            self.log_scale.zero_()

    def network_params(self):
        return self.net.params()

    def network_apply(self, net_params, xs):
        return self.net.apply(net_params, xs)

    def network_apply_taylor(self, net_params, xs, closure):
        """The network's Taylor state: through the fused Taylor kernel when
        the (layout, closure) is in its scope, else the generic traversal."""
        plan = self._fused_taylor_plan(closure)
        if plan is not None:
            return fused_taylor.fused_taylor_taps(
                fused_taylor.pack_weights(net_params, self.layer_names), xs,
                plan)
        return self.net.taylor_taps(net_params, xs, closure)

    def _fused_taylor_plan(self, closure):
        key = tuple(closure)
        if key not in self._taylor_plans:
            args = (self.net.tokens, self.net.activations, list(closure),
                    self.net.layer_shapes, self.total)
            self._taylor_plans[key] = (
                fused_taylor.TaylorPlan(*args)
                if fused_taylor.supports(*args, dtype=self.dtype) else None)
        return self._taylor_plans[key]

    def network_apply_predict(self, net_params, xs):
        if self._mlp_plan is None:
            return self.network_apply(net_params, xs)
        return fused_mlp.fused_mlp_forward(
            fused_taylor.pack_weights(net_params, self.layer_names),
            xs.contiguous(), self._mlp_plan)


# Migration alias: the reference exports `TorchModel` as the subclassing base.
TorchModel = Model
