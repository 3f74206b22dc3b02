"""Model base class and the default layout-built model, in PyTorch.

Counterpart of ``pydens_tpu/models/base.py``.  A model is an ``nn.Module``
holding its parameters — the network's ``fc{i}`` layers, the trainable
``log_scale`` of the time gate and the ``V``-token ``variables`` — and
functional entry points that take an explicit parameter tree

``{'net': {'fc1': {'w', 'b'}, ...}, 'log_scale': scalar,
   'variables': {name: tensor, ...}}``

(:attr:`Model.params` returns the live one), so the Solver can train views
into one flat parameter vector.  The ansatz binding boundary and initial
conditions exactly is the reference's (``model_torch.py:107-128``), with
``pydens_tpu``'s second initial condition and periodic binding.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from . import jets
from .jets import Jet
from .. import tracing
from .layout import make_layout_network, make_modified_mlp_network
from ..ops.tokens import (as_device, member_scope, member_value, to_host,
                          variable_scope)
from ..ops import fused_mlp, fused_taylor
from ..utils.inputs import normalize_inputs

__all__ = ["Model", "ConvBlockModel", "TorchModel", "resolve_device"]

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


def _constant_condition(value, dtype, device):
    """A non-callable condition as a callable returning one device tensor;
    a 1-D vector (one value per solution component) is pre-shaped to
    ``(1, k)`` so no batch size can reinterpret it."""
    value = np.asarray(value.detach().cpu().numpy()
                       if hasattr(value, "detach") else value,
                       dtype=np.float32)
    if value.ndim == 1 and value.shape[0] > 1:
        value = value.reshape(1, -1)
    tensor = torch.as_tensor(value, dtype=dtype, device=device)

    def condition(*cols):
        return tensor
    condition.constant = True   # no derivative in the ansatz's taps
    return condition


def _host_values(out):
    """A condition's value on the host as float64 numpy."""
    if torch.is_tensor(out):
        out = out.detach().cpu().numpy()
    return np.asarray(out, np.float64)


class Variable(nn.Parameter):
    """The parameter of a ``V`` variable or a ``Field`` leaf.  Besides
    being a parameter, it reads back on the host through ``np.asarray``,
    detached and copied, from any device, as ``pydens_tpu``'s arrays do:
    ``float(np.asarray(solver.params['variables']['c'])[0])`` (a bfloat16
    value as float32)."""

    def __array__(self, dtype=None, copy=None):
        return np.array(to_host(self), dtype=dtype)


def _mixed_partial(fn, m, zero, one):
    """``d^m fn(s_0, ..., s_{m-1}) / ds_0 ... ds_{m-1}`` at 0: ``m`` nested
    ``torch.func.jvp`` over the 0-d scalars, each with tangent ``one``."""
    if m == 0:
        return fn()

    def inner(*head):
        return torch.func.jvp(lambda s: fn(*head, s), (zero,), (one,))[1]
    return _mixed_partial(inner, m - 1, zero, one)


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
                 initial_condition_t=None, **kwargs):
        super().__init__()
        if "periodic" in kwargs:
            # Only models that implement the periodic embedding take it.
            raise ValueError(
                f"{type(self).__name__} does not support periodic= — "
                "use ConvBlockModel or implement the embedding in your "
                "model body")
        if kwargs:
            raise ValueError(
                f"{type(self).__name__} got unknown keyword argument(s) "
                f"{sorted(kwargs)} — check the spelling against the model's "
                "constructor (layout/features/units/activation/periodic/"
                "dtype/...)")
        self.ndims = ndims
        self.ndims_spatial = ndims if initial_condition is None else ndims - 1
        self.nparams = nparams
        self.total = ndims + nparams
        self.dtype = dtype
        self.device = resolve_device(device)

        if initial_condition is None or callable(initial_condition):
            self.initial_condition = initial_condition
        else:
            if np.ndim(initial_condition) > 1:
                raise ValueError(
                    "a non-callable initial_condition must be a scalar or a "
                    "1-D per-component vector; got shape "
                    f"{tuple(np.shape(initial_condition))}")
            self.initial_condition = _constant_condition(
                initial_condition, dtype, self.device)
        # The second initial condition u_t(x, t0) of problems second order
        # in time (the wave equation), bound by the squared gate.
        if initial_condition_t is None:
            self.initial_condition_t = None
        else:
            if initial_condition is None:
                raise ValueError("initial_condition_t requires "
                                 "initial_condition")
            self.initial_condition_t = (
                initial_condition_t if callable(initial_condition_t)
                else _constant_condition(initial_condition_t, dtype,
                                         self.device))
        self.boundary_condition = boundary_condition
        self.domain = _normalize_domain(domain, ndims)

        self.log_scale = nn.Parameter(
            torch.zeros((), dtype=dtype, device=self.device))
        # The V-token variables (and a Field's leaves), under keys of
        # their own: a module's parameter name cannot hold the dots of
        # ``kappa.fc1.w``.
        self.variables = nn.ParameterDict()
        self._variable_keys = {}   # name -> key in self.variables
        self.periodic_dims = ()   # set by models with a periodic embedding
        # The decaying IC binding of a periodic model: True opts in, False
        # keeps the persistent binding silently, None keeps it after the
        # wrap probe (:meth:`_ic_decay_engaged`).
        self._ic_decay = None
        # Interpretation of 1-D callable condition outputs, frozen at the
        # Solver's one-row discovery run ('per_point' | 'per_component').
        self._cond_modes = {}
        self._frozen_layers = set()
        self._frozen_variables = set()
        # Ensemble members (make_ensemble): every parameter leaf then
        # carries a leading (n_models,) axis.
        self.n_models = 1
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
                "variables": {name: self.variables[key] for name, key
                              in self._variable_keys.items()}}

    def variable(self, name):
        """The parameter of the ``V`` variable (or Field leaf) ``name``."""
        return self.variables[self._variable_keys[name]]

    def set_variables(self, values):
        """Create the ``V``-token variables from their initial values (in
        an ensemble, one copy per member)."""
        for name, value in values.items():
            value = torch.as_tensor(np.asarray(value), dtype=self.dtype,
                                    device=self.device)
            if self.n_models > 1:
                value = value.expand((self.n_models,) + value.shape).clone()
            key = self._variable_keys.setdefault(
                name, f"v{len(self._variable_keys)}")
            self.variables[key] = Variable(value)
        self._params_ready = True

    def make_ensemble(self, n_models):
        """Stack every parameter to ``n_models`` members: each leaf gets a
        leading ``(n_models,)`` axis (``pydens_tpu``'s vmapped init; draw
        the members with :meth:`reset_parameters`).  The network then maps
        points to ``(n_models, N, n_out)`` and the ansatz reads member-major
        rows (:meth:`member_rows`)."""
        self.n_models = int(n_models)
        for module in self.modules():
            for name, p in list(module._parameters.items()):
                if p is not None:
                    module._parameters[name] = type(p)(
                        p.detach().expand((self.n_models,) + p.shape)
                        .clone())

    def member_rows(self, t):
        """The network's per-member ``(K, N, c)`` output as member-major
        rows ``(K * N, c)``, the layout every row-wise step of an ensemble
        (ansatz, equation, criterion) reads; a single model's as it is."""
        return t if self.n_models == 1 else t.reshape(-1, t.shape[-1])

    def member_view(self, xs):
        """Member-major rows ``(K * N, c)`` as ``(K, N, c)``."""
        return (xs if self.n_models == 1
                else xs.reshape(self.n_models, -1, xs.shape[-1]))

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
        """Copy a parameter tree (same structure as :attr:`params`; an
        ensemble's stacked, as ``pydens_tpu``'s) into the model's
        parameters."""
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
        """Full forward: network body then ansatz. ``xs`` is ``(N, total)``;
        in an ensemble member-major rows ``(K * N, total)``, member ``k``'s
        points in rows ``k N .. (k + 1) N - 1``."""
        return self.anzatc(self.member_rows(self.network_apply(
            params["net"], self.member_view(xs))), xs, params)

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

    def _ic_decay_engaged(self):
        """Whether the decaying IC binding of a periodic model is on: only
        when asked for (``periodic_ic_decay=True``).  ``pydens_tpu``
        measured the persistent binding better at every budget tested
        (BENCHMARKS.md "Allen-Cahn"); left unset, an IC that does not wrap
        gets one advisory warning and the persistent binding.
        ``ConvBlockModel`` settles this when it is built, so the probe
        never runs inside a fit step or a graph capture."""
        if self._ic_decay is None:
            if self._probe_ic_wrap_incompatible():
                warnings.warn(
                    "the initial condition is incompatible with the "
                    "periodic wrap (value/slope/curvature mismatch across "
                    "the identified boundary): the exact-IC binding "
                    "carries that kink into the solution for all t. The "
                    "persistent binding is kept — it measured better than "
                    "the decaying alternative at every budget tested "
                    "(BENCHMARKS.md \"Allen-Cahn\"). Pass "
                    "periodic_ic_decay=True to opt into the decaying "
                    "binding, or periodic_ic_decay=False to silence this "
                    "warning.")
            self._ic_decay = False
        return self._ic_decay

    def _probe_ic_wrap_incompatible(self):
        """Whether an initial condition breaks value, slope or curvature
        continuity across a periodic wrap, probed on CPU tensors."""
        conds = [self.initial_condition]
        if self.initial_condition_t is not None:
            conds.append(self.initial_condition_t)
        try:
            return any(self._wrap_mismatch(cond, d)
                       for cond in conds for d in self.periodic_dims)
        except Exception as exc:  # pylint: disable=broad-except
            # An IC the probe cannot evaluate (V tokens, device-only
            # tensors, ...).
            warnings.warn(
                "could not probe the initial condition for periodic wrap "
                f"compatibility ({exc!r}); assuming compatible (pass "
                "periodic_ic_decay=True to force the decaying binding)")
            return False

    def _wrap_mismatch(self, cond, d):
        """True if ``cond`` (a callable of the spatial columns) breaks
        value, slope or curvature continuity across periodic dim ``d``'s
        wrap (``pydens_tpu/models/base.py:410-514``).  Every probe point
        lies inside the domain (one-sided stencils at each end of the
        wrap); one call of ``cond`` on CPU tensors and one host read.  The
        stencils' truncation floor is calibrated at interior points (the
        median of five), and the seam is flagged only above 4x it."""
        nds = self.ndims_spatial
        rng = np.random.default_rng(0)
        k = 4   # probe points for the other spatial coordinates
        cols = []
        for i in range(nds):
            lo_i, hi_i = (float(v) for v in self.domain[i])
            cols.append(rng.uniform(lo_i, hi_i, k).astype(np.float32))
        lo, hi = (float(v) for v in self.domain[d])
        span = hi - lo
        h = 0.05 * span
        calib = [lo + frac * span for frac in (0.18, 0.34, 0.5, 0.66, 0.82)]
        interior = [lo + frac * span
                    for frac in (0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                                 0.875)]
        xd = np.asarray(
            interior
            + [c + i * h for c in calib for i in range(-3, 4)]
            + [lo + i * h for i in range(4)]     # forward stencil at lo
            + [hi - i * h for i in range(4)],    # backward stencil at hi
            np.float32)
        cs = [np.tile(c, xd.size) for c in cols]
        cs[d] = np.repeat(xd, k)
        n_rows = xd.size * k
        out = _host_values(cond(*[torch.from_numpy(c) for c in cs]))
        if out.ndim == 0:   # a scalar constant
            out = np.full(n_rows, float(out))
        elif out.shape[0] != n_rows:
            # A constant output, e.g. a vector IC of shape (n_out,) or
            # (1, n_out) whatever the batch.
            out = np.broadcast_to(out, (n_rows,) + out.shape)
        out = out.reshape(xd.size, k, -1)
        ncal = len(calib)
        cal = out[7:7 + 7 * ncal].reshape(ncal, 7, k, -1)
        flo = out[7 + 7 * ncal:11 + 7 * ncal]
        fhi = out[11 + 7 * ncal:15 + 7 * ncal]

        def fwd(p):   # p[i] = f(x + i*h), i = 0..3; normalized by span
            return ((-3 * p[0] + 4 * p[1] - p[2]) / (2 * h) * span,
                    (2 * p[0] - 5 * p[1] + 4 * p[2] - p[3])
                    / (h * h) * span * span)

        def bwd(p):   # p[i] = f(x - i*h)
            return ((3 * p[0] - 4 * p[1] + p[2]) / (2 * h) * span,
                    (2 * p[0] - 5 * p[1] + 4 * p[2] - p[3])
                    / (h * h) * span * span)

        per_point = [[], []]
        for c in range(ncal):
            fq = fwd([cal[c, 3 + i] for i in range(4)])
            bq = bwd([cal[c, 3 - i] for i in range(4)])
            for j in range(2):
                per_point[j].append(float(np.max(np.abs(fq[j] - bq[j]))))
        floor = [float(np.median(p)) for p in per_point]
        value_scale = max(1e-6, float(np.max(np.abs(out))))
        quantities = [(flo[0],) + fwd(flo), (fhi[0],) + bwd(fhi)]
        for (a, b), rtol, flr in zip(zip(*quantities), (1e-3, 1e-3, 3e-3),
                                     [0.0] + floor):
            scale = max(float(np.max(np.abs(a))),
                        float(np.max(np.abs(b))), value_scale)
            if not np.all(np.isfinite(a - b)):
                return True
            if float(np.max(np.abs(a - b))) > max(rtol * scale, 4 * flr):
                return True
        return False

    def anzatc(self, u, xs, params):
        """Ansatz binding boundary/initial conditions exactly
        (``model_torch.py:107-128``):

        * BC: ``u * prod((x-lo)(hi-x)/(hi-lo)^2) + bc`` over the spatial
          dims — the polynomial vanishes on the whole boundary;
        * IC: ``(sigmoid((t-t0)/exp(log_scale)) - 0.5) * u + ic(x_spatial)``
          with ``t`` the last variable column and ``t0`` its lower bound;
          with a second initial condition ``gate² * u + ic + (t-t0) *
          ic_t``, so ``u_t(t0) = ic_t`` too.

        Periodic dims carry no Dirichlet product (their embedding makes the
        solution periodic); a periodic model's IC terms may decay
        (``periodic_ic_decay=True``).  Parameter columns (``nparams``)
        never enter the ansatz.  In an ensemble the rows are member-major:
        ``log_scale`` and the ``V`` tokens the conditions read are each
        member's own.
        """
        with member_scope(self.n_models, u.shape[0] // self.n_models):
            return self._anzatc(u, xs, params)

    def _anzatc(self, u, xs, params, p=None):
        """The ansatz of :meth:`anzatc`; with a multi-index ``p`` its
        :class:`~pydens_tpu_torch.models.jets.Jet` in the polarization
        scalars of ``p`` (``u`` the network's jet): each coordinate column
        ``c`` shifted by the scalars ``s_i`` with ``p[i] == c``."""
        nds = self.ndims_spatial
        rows = xs.shape[0]
        n_out = (u.c[0] if isinstance(u, Jet) else u).shape[1]
        lower = [float(lims[0]) for lims in self.domain]
        upper = [float(lims[1]) for lims in self.domain]
        t0 = lower[-1]

        def coord(c):
            col = xs[:, c:c + 1]
            return col if p is None else Jet.coordinate(col, c, p)

        if self.boundary_condition is not None:
            shape_fn = None
            for i in range(nds):
                if i in self.periodic_dims:
                    continue
                xi = coord(i)
                lo_i, hi_i = lower[i], upper[i]
                inv_span2 = 1.0 / ((hi_i - lo_i) * (hi_i - lo_i))
                term = (xi - lo_i) * (hi_i - xi) * inv_span2
                shape_fn = term if shape_fn is None else shape_fn * term
            bc = self.boundary_condition
            if callable(bc):
                bc = self._condition("boundary_condition", bc, xs, p, n_out)
            u = (u if shape_fn is None else u * shape_fn) + bc

        if self.initial_condition is not None:
            t = coord(self.ndims - 1)
            ic = self._condition("initial_condition", self.initial_condition,
                                 xs, p, n_out)
            gate = jets.sigmoid((t - t0) / member_value(
                torch.exp(params["log_scale"]), self.n_models,
                rows // self.n_models)) - 0.5
            ic_decay = 1.0
            if self.periodic_dims and self._ic_decay_engaged():
                # The opt-in decay, on a fixed timescale of a quarter of
                # the time span (a trainable one collapses to 0 and drops
                # the IC, pydens_tpu/models/base.py:588-604); tau^2 has
                # zero slope at t0, so u_t(t0) stays bound too.
                t_lo, t_hi = self.domain[self.ndims - 1]
                tau = (t - t0) / (0.25 * (float(t_hi) - float(t_lo)))
                ic_decay = 2.0 - 2.0 * jets.sigmoid(tau * tau)
            if self.initial_condition_t is None:
                u = gate * u + ic * ic_decay
            else:
                ic_t = self._condition("initial_condition_t",
                                       self.initial_condition_t, xs, p,
                                       n_out)
                u = gate * gate * u + (ic + (t - t0) * ic_t) * ic_decay
        return u

    def _condition(self, key, cond, xs, p, n_out):
        """A callable condition of the spatial columns at ``xs``, shaped
        against the ``(rows, n_out)`` output; with a multi-index ``p`` its
        jet: a subset's coefficient is the condition's mixed partial in the
        columns of ``p`` it holds (zero where one is not spatial, or for a
        constant condition), by nested ``torch.func.jvp`` of the condition
        alone, each distinct multi-index once."""
        nds, rows = self.ndims_spatial, xs.shape[0]

        def value(cols):
            out = as_device(cond(*cols), xs.device, self.dtype)
            return self._normalize_cond(key, out, rows, n_out)

        cols = [xs[:, i] for i in range(nds)]
        if p is None:
            return value(cols)
        jet = Jet.constant(value(cols), len(p))
        if getattr(cond, "constant", False):
            return jet
        zero, one = xs.new_zeros(()), xs.new_ones(())
        partials = {}
        for mask in range(1, 1 << len(p)):
            mi = tuple(sorted(p[i] for i in range(len(p)) if mask >> i & 1))
            if any(c >= nds for c in mi):
                continue
            if mi not in partials:
                def shifted(*svec, mi=mi):
                    moved = list(cols)
                    for c, s in zip(mi, svec):
                        moved[c] = moved[c] + s
                    return value(moved)
                partials[mi] = _mixed_partial(shifted, len(mi), zero, one)
            jet.c[mask] = partials[mi]
        return jet

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

    def network_taylor_plain(self, net_params, xs, closure):
        """The network's Taylor state off the kernels: a model's own
        traversal (:class:`ConvBlockModel` skips the fused Taylor
        kernels)."""
        return self.network_apply_taylor(net_params, xs, closure)

    def full_taps(self, params, xs, derivs, plain=False):
        """All requested pure field taps of the FULL model (network body +
        ansatz) in one Taylor-mode network traversal (with ``plain``, the
        network's plain traversal, off the kernels).

        The network propagates batched tangents (``network_apply_taylor``);
        the ansatz composes exactly through a polarized scalar substitution:
        with one scalar per position of the multi-index ``p`` and the
        network's multilinear expansion

            ``net(s_0..s_{m-1}) = V + sum over nonempty position subsets B
            of (prod_{i in B} s_i) * tap[sorted(p[B])]``,

        the mixed partial ``d^m/(ds_0..ds_{m-1})`` of
        ``anzatc(net(s), xs + sum_i s_i e_{p_i})`` at 0 is exactly the
        composite's derivative.  The ansatz runs on
        :class:`~pydens_tpu_torch.models.jets.Jet` s, every quantity's
        multilinear coefficients in the scalars (forward mode written out;
        a callable condition's own partials by nested ``torch.func.jvp``),
        so every node of the parameter gradient's graph is built in this
        forward pass, in program order: no value depends on the order in
        which the engine runs nodes, whatever autograd work the process did
        before (a ``create_graph`` backward would add nodes numbered by the
        device thread).  Returns ``{multi-index: (N, n_out)}``, including
        ``()``; in an ensemble ``N`` is the member-major rows
        (:meth:`member_rows`).
        """
        closure = self.plan_closure(derivs)
        traversal = (self.network_taylor_plain if plain
                     else self.network_apply_taylor)
        V, taps = traversal(params["net"], xs, closure)
        V = self.member_rows(V)
        taps = {mi: self.member_rows(t) for mi, t in taps.items()}
        if self.n_models > 1:
            xs = xs.repeat(self.n_models, 1)
        table = {(): self.anzatc(V, xs, params)}
        with member_scope(self.n_models, V.shape[0] // self.n_models):
            for mi in sorted({tuple(sorted(d)) for d in derivs},
                             key=lambda m: (len(m), m)):
                m = len(mi)
                net = Jet([V] + [taps[tuple(sorted(
                    mi[i] for i in range(m) if mask >> i & 1))]
                    for mask in range(1, 1 << m)])
                table[mi] = self._anzatc(net, xs, params, mi).top
        return table

    # -- inference ----------------------------------------------------------
    def predict_apply(self, params, xs):
        """Inference entry on a device tensor ``(N, total)``: the network
        through :meth:`network_apply_predict` (the fused MLP kernel on CUDA
        where the layout is in its scope), then the ansatz.  An ensemble
        gives every member's ``(K, N, n_out)`` from one network pass."""
        with torch.no_grad(), variable_scope("read", params["variables"]):
            u = self.member_rows(self.network_apply_predict(params["net"],
                                                            xs))
            if self.n_models == 1:
                return self.anzatc(u, xs, params)
            out = self.anzatc(u, xs.repeat(self.n_models, 1), params)
            return out.reshape(self.n_models, xs.shape[0], -1)

    def device_inputs(self, xs):
        """The points of :meth:`forward` (and ``Solver.predict``) as one
        ``(N, total)`` tensor in the model's dtype on its device."""
        with tracing.span("pydens.predict.inputs"):
            xs = normalize_inputs(xs, self.total)
        with tracing.span("pydens.predict.to_device"):
            return torch.as_tensor(xs, dtype=self.dtype, device=self.device)

    def forward(self, *xs):
        """Evaluate the model at host-supplied points (the reference's
        ``solver.model(xs)`` / ``solver.ctx.run(solver.model, xs)`` usage
        from the examples notebook).  Accepts the inputs of
        ``Solver.predict``: columns, numbers and lists, or one stacked
        ``(N, ndims + nparams)`` array or tensor on any device.
        ``nn.Module.__call__`` dispatches here, so ``model(xs)``,
        ``model(*cols)`` and ``model.forward(xs)`` are one call.  Runs
        :meth:`predict_apply` (one MLP launch where the chain is in the
        kernel's scope) and returns the ensemble mean as an ``(N, n_out)``
        numpy array, a bfloat16 model's as float32."""
        if not self._params_ready:
            raise RuntimeError("model has no parameters yet — build it "
                               "through a Solver")
        with tracing.span("pydens.predict") as sp:
            x = self.device_inputs(xs)
            if sp is not None:
                sp.attrs["points"] = x.shape[0]
            with tracing.span("pydens.predict.apply"):
                out = self.predict_apply(self.params, x)
                if self.n_models > 1:
                    out = out.mean(0)
            with tracing.span("pydens.predict.to_host"):
                return to_host(out)


class ConvBlockModel(Model):
    """Default model: network body built from the layout-string DSL.

    Mirrors ``ConvBlockModel`` (``model_torch.py:130-172``): defaults
    ``layout='fafaf'``, ``features=(20, 30, 1)``, ``activation='Sigmoid'``;
    accepts the ``units`` spelling for ``features``.  ``pydens_tpu``'s
    options, with its arguments and checks:

    * ``periodic``: ``True`` (every spatial dim), a tuple of dims, or a
      dict ``{dim: harmonics}``; each such dim enters the network as
      ``(sin, cos)(k·2π(x - lo)/(hi - lo))``, ``k = 1..m``, so the
      solution is exactly periodic there;
    * ``fourier_features``: ``m``, ``(m, sigma)`` or ``dict(m=, sigma=,
      dims=)`` (``sigma`` 10, ``dims`` the non-periodic columns): appends
      ``sin``/``cos`` of ``2π B v`` with ``pydens_tpu``'s fixed Gaussian
      ``B`` (seed 20240317);
    * ``periodic_ic_decay``: the decaying IC binding of a periodic model
      (``Model._ic_decay_engaged``);
    * ``arch='modified'`` (or ``'modified_mlp'``): the gated modified MLP;
    * ``branches``: sub-networks of the layout's ``B`` tokens;
    * ``adaptive_activation``: L-LAAF slopes on every ``a`` slot.

    Routing is fixed here.  The fused Taylor kernels take plain ``f c a``
    chains on the raw coordinates: embedded, modified, adaptive and
    branched models take the plain traversal (an embedding's Taylor state
    as its input state).  ``predict`` takes the MLP kernel after the
    embedding for ``f c a R +`` chains without slopes.
    """

    def __init__(self, ndims, initial_condition=None, boundary_condition=None,
                 domain=(0, 1), nparams=0, layout="fafaf",
                 features=(20, 30, 1), activation="Sigmoid", units=None,
                 dtype=torch.float32, device=None, periodic=None,
                 fourier_features=None, arch="mlp", periodic_ic_decay=None,
                 branches=None, adaptive_activation=None, **kwargs):
        super().__init__(ndims=ndims, initial_condition=initial_condition,
                         boundary_condition=boundary_condition, domain=domain,
                         nparams=nparams, dtype=dtype, device=device,
                         **kwargs)
        if periodic_ic_decay is not None:
            self._ic_decay = bool(periodic_ic_decay)
        if units is not None:
            features = units
        self.layout = layout
        self.features = list(features)
        self.activation = activation
        if arch in ("modified", "modified_mlp"):
            arch = "modified"
        elif arch != "mlp":
            raise ValueError(f"unknown arch {arch!r}; use 'mlp' (layout "
                             "chain, default) or 'modified' (gated "
                             "Wang-style modified MLP)")
        self.arch = arch

        if periodic is True:
            periodic = tuple(range(self.ndims_spatial))
        if isinstance(periodic, dict):
            self.periodic_harmonics = {int(d): int(m)
                                       for d, m in periodic.items()}
            periodic = tuple(self.periodic_harmonics)
        else:
            self.periodic_harmonics = {int(d): 1 for d in (periodic or ())}
        self.periodic_dims = tuple(sorted(periodic)) if periodic else ()
        for d, m in self.periodic_harmonics.items():
            if m < 1:
                raise ValueError(f"periodic dim {d} needs >= 1 harmonic, "
                                 f"got {m}")
        for d in self.periodic_dims:
            if d < 0 or d >= self.ndims_spatial:
                raise ValueError(
                    f"periodic dim {d} is not a spatial dimension "
                    f"(expected 0 <= dim < ndims_spatial="
                    f"{self.ndims_spatial}; negative indices are not "
                    "supported)")
        if (boundary_condition is not None and self.periodic_dims
                and len(self.periodic_dims) == self.ndims_spatial):
            raise ValueError(
                "boundary_condition has no effect when every spatial "
                "dimension is periodic — drop one of the two")
        if periodic_ic_decay and not (self.periodic_dims
                                      and self.initial_condition is not None):
            raise ValueError(
                "periodic_ic_decay=True replaces the persistent exact-IC "
                "binding of a PERIODIC model — it needs both periodic= "
                "dims and an initial_condition (got "
                f"periodic_dims={self.periodic_dims}, initial_condition="
                f"{'set' if self.initial_condition is not None else 'None'})")
        # Random Fourier features: B drawn exactly as pydens_tpu draws it,
        # so both packages embed alike and checkpoints reload against the
        # same embedding.
        self._rff_b = None
        self._rff_dims = ()
        if fourier_features is not None:
            if isinstance(fourier_features, dict):
                m = int(fourier_features["m"])
                sigma = float(fourier_features.get("sigma", 10.0))
                dims = fourier_features.get("dims")
            elif isinstance(fourier_features, (tuple, list)):
                m, sigma = (int(fourier_features[0]),
                            float(fourier_features[1]))
                dims = None
            else:
                m, sigma, dims = int(fourier_features), 10.0, None
            if dims is None:
                dims = tuple(i for i in range(self.total)
                             if i not in self.periodic_dims)
            dims = tuple(sorted(int(d) for d in dims))
            for d in dims:
                if not 0 <= d < self.total:
                    raise ValueError(f"fourier_features dim {d} out of "
                                     f"range for {self.total} input columns")
                if d in self.periodic_dims:
                    raise ValueError(
                        f"dim {d} is periodic — random Fourier features of "
                        "the raw value would break the exact periodicity; "
                        "drop it from fourier_features dims")
            if m < 1 or not dims:
                raise ValueError("fourier_features needs m >= 1 and at "
                                 "least one input dim")
            rng = np.random.default_rng(20240317)
            self._rff_b = np.asarray(rng.normal(0.0, sigma, (m, len(dims))),
                                     np.float32)
            self._rff_dims = dims
            self._rff_bt = torch.as_tensor(self._rff_b.T.copy(), dtype=dtype,
                                           device=self.device)
        self._embedded = bool(self.periodic_dims) or self._rff_b is not None
        in_dim = (self.total
                  + sum(2 * m - 1 for m in self.periodic_harmonics.values())
                  + (0 if self._rff_b is None else 2 * self._rff_b.shape[0]))

        if self.arch == "modified":
            if layout != "fafaf":
                raise ValueError(
                    "arch='modified' builds its own gated structure — "
                    "drop the layout= argument (depth comes from "
                    "len(features))")
            if branches is not None:
                raise ValueError(
                    "arch='modified' has no layout string — branches= only "
                    "applies to 'B' tokens in a layout chain")
            if adaptive_activation is not None:
                raise ValueError(
                    "adaptive_activation= (L-LAAF slopes) applies to layout-"
                    "chain activations; the gated modified MLP has its own "
                    "trainable gate structure — use arch='mlp'")
            self.net = make_modified_mlp_network(
                self.features, activation, in_dim=in_dim, dtype=dtype,
                device=self.device)
        else:
            self.net = make_layout_network(
                layout, self.features, activation, in_dim=in_dim,
                dtype=dtype, device=self.device, branches=branches,
                adaptive_activation=adaptive_activation)
            if adaptive_activation is not None and not self.net.adaptive:
                raise ValueError(
                    f"adaptive_activation= needs at least one 'a' slot in "
                    f"layout {layout!r} (or its branches) to attach a "
                    "trainable slope to — it would be a silent no-op")
        self.layer_names = self.net.layer_names
        self._taylor_plans = {}
        # The kernels' scope, decided here: the MLP kernel after the
        # embedding, the Taylor kernels on the raw coordinates only.
        self._mlp_plan = None
        self._taylor_kernels = self.arch == "mlp" and not self._embedded
        if self.arch == "mlp" and fused_mlp.supports(
                self.net.tokens, self.net.activations, self.net.layer_shapes,
                in_dim, dtype, adaptive=self.net.adaptive):
            self._mlp_plan = fused_mlp.MlpPlan(
                self.net.tokens, self.net.activations, self.net.layer_shapes,
                in_dim)
        if not self.net.taylor_ok:
            # LayerNorm, or an activation that does not act elementwise:
            # no Taylor plan, derivatives take the nested-gradient path.
            self.network_apply_taylor = None
        if self.periodic_dims and self.initial_condition is not None:
            self._ic_decay_engaged()   # the wrap probe, once, here

    def reset_parameters(self, generator):
        self.net.reset_parameters(generator)
        with torch.no_grad():
            self.log_scale.zero_()

    def network_params(self):
        return self.net.params()

    def _embed(self, xs):
        """The input embedding: periodic dims expand to (sin, cos) pairs,
        random Fourier features follow the raw columns."""
        if not self._embedded:
            return xs
        return self._embed_state(xs, ())[0]

    def _rff_columns(self, xs):
        """The Fourier features' input columns, as slices (no index
        tensor from the host: the embedding runs inside graph captures)."""
        return torch.cat([xs[..., d:d + 1] for d in self._rff_dims], dim=-1)

    def _embed_state(self, xs, closure):
        """The embedding and its Taylor state with respect to the
        coordinates, in closed form: ``(embedded xs, {multi-index: tap})``.
        A raw column's tap is 1 for its own first derivative; ``sin`` and
        ``cos`` of a phase ``θ`` linear in the coordinates give
        ``Π ∂θ · sin(θ + mπ/2)`` (and ``cos``) for an order-``m``
        multi-index over the columns ``θ`` reads, 0 for any other."""
        vals, taps = [], {mi: [] for mi in closure}

        def trig(theta, slope):
            """sin and cos of ``theta`` and their taps; ``slope(a)`` is
            ``∂θ/∂x_a`` (a float or a row), or None where θ does not read
            column ``a``."""
            s, c = torch.sin(theta), torch.cos(theta)
            cycle = (s, c, -s, -c)
            vals.extend((s, c))
            for mi in closure:
                factors = [slope(a) for a in mi]
                if any(f is None for f in factors):
                    taps[mi].extend((torch.zeros_like(s),) * 2)
                    continue
                scale = factors[0]
                for f in factors[1:]:
                    scale = scale * f
                m = len(mi)
                taps[mi].extend((scale * cycle[m % 4],
                                 scale * cycle[(m + 1) % 4]))

        for i in range(self.total):
            xi = xs[..., i:i + 1]
            if i in self.periodic_dims:
                lo, hi = self.domain[i]
                w = 2.0 * np.pi / (float(hi) - float(lo))
                phase = w * (xi - float(lo))
                for k in range(1, self.periodic_harmonics[i] + 1):
                    trig(float(k) * phase,
                         lambda a, i=i, kw=k * w: kw if a == i else None)
            else:
                vals.append(xi)
                for mi in closure:
                    taps[mi].append(torch.ones_like(xi) if mi == (i,)
                                    else torch.zeros_like(xi))
        if self._rff_b is not None:
            proj = (2.0 * np.pi) * (self._rff_columns(xs) @ self._rff_bt)
            pos = {d: j for j, d in enumerate(self._rff_dims)}
            trig(proj, lambda a: (2.0 * np.pi) * self._rff_bt[pos[a]]
                 if a in pos else None)
        return (torch.cat(vals, dim=-1),
                {mi: torch.cat(t, dim=-1) for mi, t in taps.items()})

    def network_apply(self, net_params, xs):
        return self.net.apply(net_params, self._embed(xs))

    def network_apply_taylor(self, net_params, xs, closure):
        """The network's Taylor state: through the fused Taylor kernels
        when the (chain, closure) is in their scope, else the plain
        traversal, from the embedding's state where the model embeds."""
        plan = self._fused_taylor_plan(closure)
        if plan is not None:
            return fused_taylor.fused_taylor_taps(
                fused_taylor.pack_weights(net_params, self.net.dense_names),
                xs, plan)
        return self.network_taylor_plain(net_params, xs, closure)

    def network_taylor_plain(self, net_params, xs, closure):
        """The network's Taylor state by the plain traversal, from the
        embedding's state where the model embeds."""
        if self._embedded:
            V, taps = self._embed_state(xs, closure)
            return self.net.taylor_taps(net_params, V, closure,
                                        init=(V, taps))
        return self.net.taylor_taps(net_params, xs, closure)

    def _fused_taylor_plan(self, closure):
        key = tuple(closure)
        if key not in self._taylor_plans:
            args = (self.net.tokens, self.net.activations, list(closure),
                    self.net.layer_shapes, self.total)
            self._taylor_plans[key] = (
                fused_taylor.TaylorPlan(*args)
                if self._taylor_kernels and fused_taylor.supports(
                    *args, dtype=self.dtype, adaptive=self.net.adaptive)
                else None)
        return self._taylor_plans[key]

    def network_apply_predict(self, net_params, xs):
        if self._mlp_plan is None:
            return self.network_apply(net_params, xs)
        return fused_mlp.fused_mlp_forward(
            fused_taylor.pack_weights(net_params, self.net.dense_names),
            self._embed(xs).contiguous(), self._mlp_plan)


# Migration alias: the reference exports `TorchModel` as the subclassing base.
TorchModel = Model
