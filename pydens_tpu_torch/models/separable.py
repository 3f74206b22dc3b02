"""Separable PINN model (SPINN-style per-axis factorization), counterpart of
``pydens_tpu/models/separable.py``.

One small MLP PER INPUT AXIS maps its coordinate to ``rank * n_out``
features, and the solution on the full collocation grid is the
rank-contracted outer product

    u(x_1, ..., x_d)[o] = sum_r  prod_i  h_i(x_i)[r, o].

Training on an ``N^d``-point grid costs ``d`` MLP evaluations of ``N`` rows
each plus one contraction (``torch.einsum``) — ``O(N d)`` network work for
``N^d`` collocation points.  A ``D(f, x_i)`` tap differentiates axis
``i``'s leaf in forward mode (``ops/tokens.py``'s grid tangent): each grid
point depends on exactly one row of each axis input.

The same parameters evaluate POINTWISE too (``prod_i`` over per-point axis
features): ``predict``, ``residual`` and checkpoints work unchanged through
the pointwise path.  Chain layouts (``f``/``a`` and the width-preserving
tokens), multi-harmonic ``periodic`` embeddings per axis, constant and
callable conditions, ``initial_condition_t``, ``nparams`` (parameter
columns become extra grid axes).  Not supported, as in ``pydens_tpu``:
``fourier_features``, ``arch``, branch tokens and the Taylor plan.
"""

from __future__ import annotations

import string

import numpy as np
import torch

from .base import Model
from .jets import Jet
from .layout import make_layout_network
from ..ops.tokens import as_device, member_scope, member_value

__all__ = ["SeparableModel"]


class SeparableModel(Model):
    """Per-axis factorized model: ``sum_r prod_i h_i(x_i)[r, o]``.

    Parameters mirror :class:`ConvBlockModel` where they make sense:
    ``layout``/``features``/``activation`` describe EACH axis MLP (the last
    ``features`` entry is the factorization rank ``r``); ``n_out`` is the
    number of solution components (axis nets emit ``r * n_out`` features).
    The parameter subtrees are ``axis0``, ``axis1``, ... as in
    ``pydens_tpu``.
    """

    separable = True

    def __init__(self, ndims, initial_condition=None, boundary_condition=None,
                 domain=(0, 1), nparams=0, layout="fa fa f",
                 features=(32, 32, 32), activation="Tanh", units=None,
                 n_out=1, dtype=torch.float32, device=None, periodic=None,
                 periodic_ic_decay=None, adaptive_activation=None, **kwargs):
        if "fourier_features" in kwargs:
            raise ValueError(
                "SeparableModel does not support fourier_features= — use "
                "periodic={dim: m} multi-harmonic embeddings (per-axis, "
                "separability-preserving) instead")
        if "arch" in kwargs:
            raise ValueError("SeparableModel builds per-axis chain MLPs; "
                             "arch= does not apply")
        if "branches" in kwargs or any(t in ("B", ".") for t in layout):
            # The factorization widens the LAST dense layer to rank*n_out;
            # a branch/concat join after it would break that bookkeeping.
            raise ValueError(
                "SeparableModel's per-axis factor nets are chain MLPs — "
                "'B' branch / '.' concat tokens and branches= do not apply "
                "(the factorization rank is the last features entry); "
                "multi-component solutions use n_out=")
        super().__init__(ndims=ndims, initial_condition=initial_condition,
                         boundary_condition=boundary_condition, domain=domain,
                         nparams=nparams, dtype=dtype, device=device,
                         **kwargs)
        if periodic_ic_decay is not None:
            self._ic_decay = bool(periodic_ic_decay)
        if units is not None:
            features = units
        features = list(features)
        self.layout = layout
        self.features = features
        self.activation = activation
        self.n_out = int(n_out)
        self.rank = int(features[-1])
        if self.rank < 1 or self.n_out < 1:
            raise ValueError("need rank (last features entry) >= 1 and "
                             "n_out >= 1")
        if self.total > 24:
            raise ValueError("SeparableModel supports at most 24 input axes")

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
                raise ValueError(f"periodic dim {d} needs >= 1 harmonic")
        for d in self.periodic_dims:
            if d < 0 or d >= self.ndims_spatial:
                raise ValueError(
                    f"periodic dim {d} is not a spatial dimension "
                    f"(0 <= dim < ndims_spatial={self.ndims_spatial})")
        if (boundary_condition is not None and self.periodic_dims
                and len(self.periodic_dims) == self.ndims_spatial):
            raise ValueError(
                "boundary_condition has no effect when every spatial "
                "dimension is periodic — drop one of the two")
        if periodic_ic_decay and not (self.periodic_dims
                                      and self.initial_condition is not None):
            raise ValueError(
                "periodic_ic_decay=True needs periodic= dims and an "
                "initial_condition")

        # One chain network per input axis; the output layer is widened to
        # rank * n_out and reshaped at combine time.
        out_features = features[:-1] + [self.rank * self.n_out]
        self.axis_nets = torch.nn.ModuleList([
            make_layout_network(
                layout, out_features, activation,
                in_dim=(2 * self.periodic_harmonics[i]
                        if i in self.periodic_dims else 1),
                dtype=dtype, device=self.device,
                adaptive_activation=adaptive_activation)
            for i in range(self.total)])
        if adaptive_activation is not None and not self.axis_nets[0].adaptive:
            raise ValueError(
                f"adaptive_activation= needs at least one 'a' slot in the "
                f"per-axis layout {layout!r} to attach a trainable slope "
                "to — it would be a silent no-op")
        self.layer_names = [f"axis{i}" for i in range(self.total)]
        if self.periodic_dims and self.initial_condition is not None:
            self._ic_decay_engaged()   # the wrap probe, once, here

    # Derivatives ride the per-axis forward-mode taps; no Taylor plan.
    network_apply_taylor = None

    def reset_parameters(self, generator):
        for net in self.axis_nets:
            net.reset_parameters(generator)
        with torch.no_grad():
            self.log_scale.zero_()

    def network_params(self):
        return {f"axis{i}": net.params()
                for i, net in enumerate(self.axis_nets)}

    # -- per-axis input embedding -------------------------------------------
    def _embed_axis(self, i, x):
        """Axis input features: raw coordinate, or the exact-periodicity
        sin/cos harmonics for a periodic spatial dim (the embedding of
        ConvBlockModel, restricted to one column)."""
        if i not in self.periodic_dims:
            return x
        lo, hi = self.domain[i]
        w = 2.0 * np.pi / (float(hi) - float(lo))
        phase = w * (x - float(lo))
        cols = []
        for k in range(1, self.periodic_harmonics[i] + 1):
            cols.append(torch.sin(float(k) * phase))
            cols.append(torch.cos(float(k) * phase))
        return torch.cat(cols, dim=-1)

    # -- network body --------------------------------------------------------
    def _axis_features(self, net_params, i, x):
        """``(..., N_i, rank, n_out)`` features of axis ``i`` at the column
        ``x`` ``(..., N_i, 1)`` (an ensemble's with a leading member
        axis)."""
        h = self.axis_nets[i].apply(net_params[f"axis{i}"],
                                    self._embed_axis(i, x))
        return h.reshape(h.shape[:-1] + (self.rank, self.n_out))

    def network_apply(self, net_params, xs):
        """Pointwise forward on a stacked ``(N, total)`` batch (an
        ensemble's shared or per-member ``(K, N, total)``): the per-point
        product over the axis features — the same parameters at O(N) cost;
        used by predict, residual and the discovery run."""
        out = None
        for i in range(self.total):
            h = self._axis_features(net_params, i, xs[..., i:i + 1])
            out = h if out is None else out * h
        return torch.sum(out, dim=-2)

    def network_apply_grid(self, net_params, leaves):
        """Grid forward: each leaf is axis ``i``'s sample broadcast-shaped
        ``(1, .., N_i, .., 1, 1)``; returns the ``(N_1, .., N_d, n_out)``
        solution on the tensor-product grid (an ensemble's ``(K, N_1, ..,
        N_d, n_out)``) from one rank-contracted ``torch.einsum``."""
        hs = [self._axis_features(net_params, i, leaf.reshape(-1, 1))
              for i, leaf in enumerate(leaves)]
        letters = string.ascii_lowercase[:len(hs)]  # a..x; z=rank, y=out
        lead = "w" if self.n_models > 1 else ""     # w=member
        sub = (",".join(f"{lead}{c}zy" for c in letters)
               + f"->{lead}" + "".join(letters) + "y")
        return torch.einsum(sub, *hs)

    def grid_taps(self, params, leaves, derivs):
        """The solution and each requested pure tap on the grid of the
        broadcast-shaped axis ``leaves``, ``{multi-index: (N_1, .., N_d,
        n_out)}`` (an ensemble's ``(K, ...)``), ``()`` included: forward
        mode written out, the grid forward and its ansatz run on
        :class:`~pydens_tpu_torch.models.jets.Jet` s, each leaf shifted by
        the scalars of the multi-index that name its axis.  Every node of
        the parameter gradient's graph is built in this forward pass, in
        program order, where a grid ``D`` by ``create_graph`` pullbacks
        (``ops/tokens.py`` ``_grid_tangent``) made nodes that the device
        thread numbers after the process's earlier autograd work."""
        table = {}
        # Longest first: a pass of ``mi`` gives every sub-multi-index of it
        # too (the coefficient of each subset of its scalars).
        for mi in sorted({tuple(sorted(d)) for d in derivs},
                         key=lambda m: (-len(m), m)):
            if mi in table:
                continue
            jets = [Jet.coordinate(leaf, k, mi)
                    for k, leaf in enumerate(leaves)]
            out = self.anzatc_grid(
                self.network_apply_grid(params["net"], jets), jets, params)
            value = out.c[0]
            for mask, coef in enumerate(out.c):
                sub = tuple(sorted(mi[i] for i in range(len(mi))
                                   if mask >> i & 1))
                if sub not in table:
                    table[sub] = (torch.zeros_like(value) if coef is None
                                  else coef.expand_as(value))
        if () not in table:
            table[()] = self.anzatc_grid(
                self.network_apply_grid(params["net"], leaves), leaves,
                params)
        return table

    # -- grid-path full forward ----------------------------------------------
    def apply_leaves(self, params, leaves):
        """Equation-path forward.  2-D leaves (the Solver's discovery run
        and pointwise diagnostics) take the stacked pointwise path;
        broadcast-shaped grid leaves take the factorized path and the grid
        ansatz."""
        if leaves[0].ndim == 2:
            return self.apply(params, torch.cat(leaves, dim=1))
        u = self.network_apply_grid(params["net"], leaves)
        return self.anzatc_grid(u, leaves, params)

    def anzatc_grid(self, u, leaves, params):
        """Grid-shaped ansatz — the condition-binding math of
        :meth:`Model.anzatc` on broadcast-shaped axis leaves instead of
        stacked columns; every factor broadcasts against the ``(N_1..N_d,
        n_out)`` grid (an ensemble's ``(K, ...)``, each member through its
        own ``log_scale`` and ``V`` values).  KEEP IN STEP with
        ``Model.anzatc`` (tests/test_torch_separable.py holds pointwise ==
        grid on the full forward).

        Conditions must return values broadcastable against the grid:
        scalars, per-component ``(1, n_out)`` constants, and elementwise
        callables of the axis leaves all are.
        """
        grid = tuple(u.shape[-1 - self.total:-1])
        with member_scope(self.n_models, grid):
            return self._anzatc_grid(u, leaves, params, grid)

    def _anzatc_grid(self, u, leaves, params, grid):
        nds = self.ndims_spatial
        t = leaves[self.ndims - 1]
        lower = [float(lims[0]) for lims in self.domain]
        upper = [float(lims[1]) for lims in self.domain]
        t0 = lower[-1]

        def cond(c):
            return as_device(c(*[leaves[i] for i in range(nds)]), u.device,
                             self.dtype)

        if self.boundary_condition is not None:
            shape_fn = None
            for i in range(nds):
                if i in self.periodic_dims:
                    continue
                xi = leaves[i]
                lo_i, hi_i = lower[i], upper[i]
                inv_span2 = 1.0 / ((hi_i - lo_i) * (hi_i - lo_i))
                term = (xi - lo_i) * (hi_i - xi) * inv_span2
                shape_fn = term if shape_fn is None else shape_fn * term
            bc = self.boundary_condition
            bc = cond(bc) if callable(bc) else bc
            u = (u if shape_fn is None else u * shape_fn) + bc

        if self.initial_condition is not None:
            ic = cond(self.initial_condition)
            scale = member_value(torch.exp(params["log_scale"]),
                                 self.n_models, grid)
            gate = torch.sigmoid((t - t0) / scale) - 0.5
            ic_decay = 1.0
            if self.periodic_dims and self._ic_decay_engaged():
                t_lo, t_hi = self.domain[self.ndims - 1]
                tau = (t - t0) / (0.25 * (float(t_hi) - float(t_lo)))
                ic_decay = 2.0 - 2.0 * torch.sigmoid(tau * tau)
            if self.initial_condition_t is None:
                u = gate * u + ic * ic_decay
            else:
                ic_t = cond(self.initial_condition_t)
                u = gate * gate * u + (ic + (t - t0) * ic_t) * ic_decay
        return u
