"""Trainable unknown-FUNCTION token for inverse problems, counterpart of
``pydens_tpu/ops/fields.py``.

The reference's ``V`` token (``model_torch.py:180-188``) makes scalar /
array coefficients trainable.  ``Field`` generalizes it to unknown
*functions*: a spatially-varying coefficient κ(x) parameterized by its own
small MLP whose weights train jointly with the solution network.

    kappa = Field('kappa', features=[16, 1])

    def pde(f, x, t):
        return D(f, t) - kappa(x) * D(D(f, x), x)

Each weight/bias leaf registers as a named entry in the registry ``V``
uses (``kappa.fc1.w``, ...), so optimizer flattening, checkpoints,
``freeze_trainable(variables=[name])`` and ensemble stacking carry them
with no new state.  The initial values are drawn on the host with numpy,
seeded per field, as ``pydens_tpu`` draws them: both packages start from
the same leaves bit for bit.

A Field inside a ``D`` argument (the divergence form ``D(kappa(x) *
D(f, x), x)``) voids the Taylor plan of that equation (nested gradients
take it); the coefficient form ``kappa(x) * D(D(f, x), x)`` stays planned.
"""

from __future__ import annotations

import numpy as np
import torch

from .tokens import Expr, _VAR_SCOPES, to_host

__all__ = ["Field"]


class Field:
    """Trainable unknown function for inverse problems.

    Parameters
    ----------
    name : str
        Registry prefix; leaves appear as ``{name}.fc{i}.w`` / ``.b`` in
        ``solver.params['variables']``.  ``freeze_trainable(
        variables=[name])`` freezes the whole field by prefix.
    features : sequence of int
        Dense widths, last entry = output dimension (default ``(16, 1)``).
    activation : str | callable
        Applied between dense layers (not after the last); default Tanh.
    seed : int
        Host-side init seed (deterministic: checkpoints reload against
        the same structure).
    """

    def __init__(self, name, features=(16, 1), activation="Tanh", seed=0):
        if not name or "." in name:
            raise ValueError(
                f"Field name {name!r} must be non-empty and dot-free "
                "(dots separate the per-layer leaf names)")
        self.name = name
        self.features = [int(f) for f in features]
        if not self.features:
            raise ValueError("Field needs at least one dense layer")
        self.activation = activation
        self._seed = int(seed)
        self.in_dim = None
        self._act = None

    # -- structure -----------------------------------------------------------
    def leaf_names(self):
        return [f"{self.name}.fc{i + 1}.{p}"
                for i in range(len(self.features)) for p in ("w", "b")]

    def _ensure_built(self, in_dim):
        if self.in_dim is None:
            self.in_dim = int(in_dim)
            from ..models.layout import resolve_activation
            self._act = resolve_activation(self.activation)
        elif in_dim != self.in_dim:
            raise ValueError(
                f"Field {self.name!r} was first called with {self.in_dim} "
                f"coordinate(s), now {in_dim} — a field has one fixed "
                "signature")

    def _init_seed(self):
        # name-salted so two same-seed fields in one problem differ
        return np.random.SeedSequence([self._seed, *map(ord, self.name)])

    def _initial_leaves(self):
        rng = np.random.default_rng(self._init_seed())
        leaves = {}
        fan_in = self.in_dim
        for i, fan_out in enumerate(self.features):
            bound = 1.0 / np.sqrt(fan_in)
            leaves[f"{self.name}.fc{i + 1}.w"] = np.asarray(
                rng.uniform(-bound, bound, (fan_in, fan_out)), np.float32)
            leaves[f"{self.name}.fc{i + 1}.b"] = np.asarray(
                rng.uniform(-bound, bound, (fan_out,)), np.float32)
            fan_in = fan_out
        return leaves

    def _apply(self, leaves, x):
        """The field's MLP at ``x`` ``(N, in)``; with an ensemble's stacked
        leaves (``w`` ``(K, in, out)``) at shared ``(N, in)`` or
        per-member ``(K, N, in)`` points, giving ``(K, N, out)``."""
        h = x
        last = len(self.features) - 1
        for i in range(len(self.features)):
            w = leaves[f"{self.name}.fc{i + 1}.w"]
            b = leaves[f"{self.name}.fc{i + 1}.b"]
            h = h @ w + (b if b.dim() == 1 else b.unsqueeze(-2))
            if i < last:
                h = self._act(h)
        return h

    # -- the token -----------------------------------------------------------
    def __call__(self, *coords):
        """Evaluate the field at the given coordinate symbols; returns a
        differentiable :class:`Expr`.  Must run under a Solver scope, like
        ``V`` — the field's weights resolve from the active registry.  In
        an ensemble the rows are member-major, each member's through its
        own leaves."""
        if not _VAR_SCOPES:
            raise RuntimeError(
                f"Field {self.name!r} used outside of a Solver context — "
                "fields only work inside equation/constraint/"
                "initial-condition callables evaluated by a Solver.")
        if not coords:
            raise ValueError(f"Field {self.name!r} needs at least one "
                             "coordinate argument")
        ctx = None
        for c in coords:
            if isinstance(c, Expr):
                ctx = c.ctx
                break
        if ctx is None:
            raise TypeError(
                f"Field {self.name!r}: at least one argument must be a "
                "coordinate symbol (to evaluate at plain points after "
                "training, use field.predict(solver, ...))")
        self._ensure_built(len(coords))
        mode, store, device = _VAR_SCOPES[-1]
        if mode == "create":
            init = self._initial_leaves()
            for k, v in init.items():
                store.setdefault(k, v)
            leaves = {k: torch.as_tensor(store[k], device=device)
                      for k in self.leaf_names()}
        else:
            missing = [k for k in self.leaf_names() if k not in store]
            if missing:
                raise KeyError(
                    f"Field {self.name!r}: leaves {missing} were not "
                    "created during Solver initialization — the field must "
                    "be reachable from the equation, constraints or initial "
                    "condition at Solver construction time.")
            leaves = {k: store[k] for k in self.leaf_names()}

        def fn():
            vals = [c.value if isinstance(c, Expr) else None for c in coords]
            ref = next(v for v in vals if v is not None)
            cols = [v if v is not None else torch.full_like(ref, c)
                    for v, c in zip(vals, coords)]
            w = leaves[f"{self.name}.fc1.w"]
            x = torch.cat(cols, dim=1).to(w.dtype)
            if w.dim() == 2:
                return self._apply(leaves, x)
            members = w.shape[0]    # member-major rows, one block a member
            out = self._apply(leaves, x.reshape(members, -1, x.shape[1]))
            return out.reshape(-1, out.shape[-1])

        return Expr(fn, ctx)

    # -- post-training evaluation -------------------------------------------
    def predict(self, solver, *coords):
        """Evaluate the trained field at host points: ``kappa.predict(
        solver, xs)`` returns a numpy ``(N, out)`` array.  Accepts the same
        mixed scalar/array inputs as ``Solver.predict``; for an ensemble
        solver (``n_models > 1``) this is the ensemble mean, matching
        ``Solver.predict``."""
        out = self.predict_all(solver, *coords)
        return out.mean(axis=0) if out.ndim == 3 else out

    def predict_all(self, solver, *coords):
        """Per-model field evaluations: ``(n_models, N, out)`` for an
        ensemble solver, ``(N, out)`` otherwise; float32, as
        ``pydens_tpu`` computes them, whatever the model's dtype."""
        if self.in_dim is None:
            raise RuntimeError(f"Field {self.name!r} was never used in a "
                               "Solver problem")
        variables = solver.params["variables"]
        leaves = {}
        for k in self.leaf_names():
            if k not in variables:
                raise KeyError(f"Field {self.name!r}: leaf {k} missing from "
                               "solver variables")
            leaves[k] = variables[k].detach().float()
        cols = [np.asarray(c, np.float32).reshape(-1, 1) for c in
                np.broadcast_arrays(*[np.atleast_1d(np.asarray(c, np.float32))
                                      for c in coords])]
        if len(cols) != self.in_dim:
            raise ValueError(
                f"Field {self.name!r} takes {self.in_dim} coordinate(s), "
                f"got {len(cols)}")
        xs = torch.as_tensor(np.concatenate(cols, axis=1),
                             device=solver.device)
        with torch.no_grad():
            return to_host(self._apply(leaves, xs))

    def predict_std(self, solver, *coords):
        """Per-point epistemic std of the recovered field across ensemble
        members, shape ``(N, out)``.  Requires ``n_models > 1``."""
        out = self.predict_all(solver, *coords)
        if out.ndim != 3:
            raise ValueError(
                f"Field {self.name!r}: predict_std needs an ensemble solver "
                "(n_models > 1)")
        return out.std(axis=0)

    def __repr__(self):
        return (f"Field({self.name!r}, features={self.features}, "
                f"in_dim={self.in_dim})")
