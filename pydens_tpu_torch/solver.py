"""Solver: trains a neural network to satisfy a differential equation.

Counterpart of ``pydens_tpu/solver.py`` with the same public surface for the
ported slice (``__init__`` / ``fit`` / ``predict`` / ``reshape_and_concat``
/ ``.losses`` / ``.model``) and the same reference quirks:

* ``V``-token variables are discovered by a fake run of model + equation
  at construction (``model_torch.py:319-325``) — here a real forward on one
  row, which also records the equation's derivative plan.
* Training state is ONE flat parameter vector; the network sees views into
  it.  Each step is a loss, one ``torch.autograd.grad`` and an in-place
  Adam update, all on the device: losses go into a preallocated device
  buffer that the host reads once per chunk.
* The default sampler is U(0, 1) per column and IGNORES ``domain``
  (``model_torch.py:431``), drawn on the device from the Solver's
  ``torch.Generator`` once per chunk; so is any sampler with a device path
  (``sample_device``).  Host-only samplers are drawn on the host.
* Constraints run in the discovery run too, in a context of their own, so
  a ``V`` used only in a constraint is trained and the derivative plan is
  the equation's alone.
"""

from __future__ import annotations

import re
import sys
import time
import warnings

import numpy as np
import torch

from .models import ConvBlockModel
from .models.base import resolve_device
from .ops.tokens import (Expr, EvalContext, _batch_diagonal_grad,
                         as_array, variable_scope)
from .utils.criteria import resolve_criterion
from .utils.optimizers import resolve_optimizer

__all__ = ["Solver"]


def _leaf_fn(ctx, k):
    return lambda: ctx.leaves[k]


def _as_residual_list(out):
    """One residual or a tuple/list of coupled residuals."""
    if isinstance(out, (tuple, list)):
        return list(out)
    return [out]


def _tree_leaves(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict in sorted-key order — the
    order ``jax.tree.leaves`` flattens the JAX package's parameter tree."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _tree_leaves(tree[key], prefix + (key,))
        return out
    return [(prefix, tree)]


def _skeleton(tree):
    """A copy of the tree's dict structure (empty dicts included)."""
    return ({k: _skeleton(v) for k, v in tree.items()}
            if isinstance(tree, dict) else None)


class _FlatSpec:
    """Paths, shapes and offsets of the flat parameter vector."""

    def __init__(self, tree):
        self.skeleton = _skeleton(tree)
        leaves = _tree_leaves(tree)
        self.paths = [p for p, _ in leaves]
        self.shapes = [tuple(t.shape) for _, t in leaves]
        sizes = [int(np.prod(s)) for s in self.shapes]
        self.offsets = np.cumsum([0] + sizes).tolist()

    def flatten(self, tree):
        return torch.cat([t.reshape(-1) for _, t in _tree_leaves(tree)])

    def unflatten(self, theta):
        """The parameter tree as views into ``theta``."""
        tree = _skeleton(self.skeleton)
        for i, path in enumerate(self.paths):
            node = tree
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = theta[self.offsets[i]:self.offsets[i + 1]].view(
                self.shapes[i])
        return tree


# Keyword arguments of pydens_tpu's fit that this package does not take
# yet, with their ROADMAP.md Queue 1 item.
_FIT_NOT_PORTED = {"callback": 8, "checkpoint_path": 8, "checkpoint_every": 8,
                   "profile_dir": 8, "adaptive": 10, "rba": 10, "causal": 10,
                   "causal_axis": 10, "loss_balancing": 10}


def _is_number(x):
    return isinstance(x, (int, float, np.integer, np.floating))


def _numel(x):
    return x.numel() if torch.is_tensor(x) else int(np.prod(np.shape(x)))


def _normalize_loss_terms(loss_terms):
    """``((name, weight), ...)`` from a name, a list of names or a
    ``{name: weight}`` dict.  Dict keys are validated (a misspelled key
    raises); the list form keeps the reference's quirk of dropping unknown
    names other than constraint names (``model_torch.py:447-449``)."""
    if isinstance(loss_terms, dict):
        for k in loss_terms:
            if (str(k) != "equation"
                    and not re.fullmatch(r"constraint_?\d+", str(k))):
                raise ValueError(
                    f"unknown loss term {str(k)!r}; expected 'equation' "
                    "or 'constraint_<k>'")
        return tuple((str(k), float(v)) for k, v in loss_terms.items())
    if not isinstance(loss_terms, (tuple, list)):
        loss_terms = (loss_terms,)
    return tuple((str(t), 1.0) for t in loss_terms)


def _constraint_terms(loss_terms, n_constraints):
    """``[(k, weight), ...]`` of the ``constraint_k`` / ``constraint<k>``
    terms, in request order, each checked against the constraints given."""
    nums = []
    for term, w in loss_terms:
        if "constraint" not in term:
            continue
        m = re.fullmatch(r"constraint_?(\d+)", term)
        if m is None:
            raise ValueError(
                f"malformed loss term {term!r}; expected "
                "'constraint_<k>' (e.g. 'constraint_0')")
        nums.append((int(m.group(1)), w))
    for num, _ in nums:
        if num >= n_constraints:
            raise ValueError(
                f"loss term 'constraint_{num}' requested but only "
                f"{n_constraints} constraints were supplied to Solver")
    return nums


class Solver:
    r"""Solver of differential equations with neural networks.

    Parameters
    ----------
    equation : callable
        ``equation(f, *coords)`` built with ``D`` and torch (or
        ``pydens_tpu_torch``) math, e.g.::

            def pde(f, x, y):
                return D(D(f, x), x) + D(D(f, y), y) - 5 * torch.sin(np.pi * (x + y))

    ndims : int
        Number of variables (including time, if any).
    initial_condition : callable or float, optional
        Initial condition over the spatial variables; enables the time gate.
    boundary_condition : float or callable, optional
        Dirichlet condition, bound exactly by the ansatz.
    domain : tuple or list
        ``(lo, hi)`` for all dims or a per-dim list of pairs.
    nparams : int
        Number of sampled equation parameters (parametric families).
    model : class
        Model class (default :class:`ConvBlockModel`); receives all extra
        kwargs (``layout``, ``features``/``units``, ``activation``, ...).
    constraints : callable or sequence of callables, optional
        ``constraint(f, *coords)``, where ``f`` evaluates the model at any
        points (``f(np.array([0.5]))``; ``D`` works on ``f(x, ...)`` of
        coordinate symbols; ``f.grad(*pts, wrt=k or (k, l, ...))`` is a
        derivative at fixed points).  Trained through the ``constraint_k``
        loss terms as ``criterion(c, 0)``.
    seed : int
        Seed of the parameter-init generator (CPU) and of the sampling
        generator (on ``device``).
    device : str or torch.device, optional
        Where parameters live and training runs; default CUDA when
        available, else the CPU.
    """

    def __init__(self, equation, ndims, initial_condition=None,
                 boundary_condition=None, domain=(0, 1), nparams=0,
                 model=ConvBlockModel, constraints=None, seed=0, device=None,
                 **kwargs):
        self.equation = equation
        if constraints is None:
            self.constraints = ()
        elif isinstance(constraints, (tuple, list)):
            self.constraints = tuple(constraints)
        else:
            self.constraints = (constraints,)
        self.device = resolve_device(device)
        self.losses = []
        self.history = []   # one record per fit call
        self._step_counter = 0
        self.model = model(**kwargs, ndims=ndims,
                           initial_condition=initial_condition,
                           boundary_condition=boundary_condition,
                           domain=domain, nparams=nparams, device=self.device)
        seed = 0 if seed is None else int(seed)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self._opt = None
        self._opt_state = None

        # Discovery: one real forward of model + equation + constraints on a
        # single row of domain midpoints registers the V variables and
        # records which pure field derivatives the equation takes (the
        # plan).  The constraints run in a context of their own, so D used
        # there does not void the equation's plan.
        total = self.model.total
        mids = ([0.5 * (float(lo) + float(hi)) for lo, hi in
                 self.model.domain] + [0.5] * nparams)
        leaves = [torch.full((1, 1), m, dtype=self.model.dtype,
                             device=self.device).requires_grad_(True)
                  for m in mids]
        registry = {}
        params = self.model.params
        with variable_scope("create", registry, self.device):
            ctx = EvalContext(leaves)
            f = Expr(lambda: self.model.apply_leaves(params, ctx.leaves), ctx,
                     deriv=())
            coords = [Expr(_leaf_fn(ctx, k), ctx, leaf_index=k)
                      for k in range(total)]
            try:
                residuals = _as_residual_list(self.equation(f, *coords))
            except TypeError as err:
                if "positional argument" in str(err):
                    raise TypeError(
                        f"equation callable must accept (f, *coords) with "
                        f"{total} coordinate argument(s) — one per variable "
                        f"and one per parameter (ndims={ndims} + "
                        f"nparams={nparams}): {err}") from None
                raise
            for r in residuals:
                as_array(r)
            ctx_c = EvalContext(leaves)
            coords_c = [Expr(_leaf_fn(ctx_c, k), ctx_c, leaf_index=k)
                        for k in range(total)]
            fwd = self._make_forward(params, ctx_c)
            for constraint in self.constraints:
                as_array(constraint(fwd, *coords_c))
        self._plan_derivs = frozenset(ctx.derivs)
        self._plan_ok = (ctx.plan_ok and bool(ctx.derivs)
                         and self.model.supports_taylor)
        self.model.set_variables(registry)

    @property
    def params(self):
        """The full parameter tree (net + log_scale + V variables)."""
        return self.model.params

    @property
    def optimizer(self):
        return self._opt

    # ------------------------------------------------------------------
    # input normalization
    # ------------------------------------------------------------------
    @classmethod
    def reshape_and_concat(cls, tensors):
        """Cast, reshape and concatenate mixed inputs to an ``(N, D)``
        float32 array, with the reference's quirks (``model_torch.py:
        327-362``): batch size is the max element count; scalars are tiled;
        numpy arrays whose size mismatches the batch are tiled from their
        first element; torch tensors must match; lists become columns."""
        xs, torch_origin = [], []
        for x in tensors:
            was_torch = hasattr(x, "detach")
            if was_torch:
                x = x.detach().cpu().numpy()
            xs.append(x)
            torch_origin.append(was_torch)
        sizes = ([int(np.prod(x.shape)) for x in xs
                  if isinstance(x, np.ndarray)]
                 + [int(np.prod(np.asarray(x).shape)) for x in xs
                    if isinstance(x, (tuple, list))])
        batch_size = int(np.max(sizes)) if sizes else 1
        cols = []
        for x, was_torch in zip(xs, torch_origin):
            if _is_number(x):
                col = np.tile(np.float32(x), (batch_size, 1))
            elif isinstance(x, np.ndarray):
                if x.size != batch_size:
                    if was_torch:
                        raise ValueError(
                            f"torch tensor with {x.size} elements cannot be "
                            f"concatenated with batch size {batch_size} "
                            "(sizes must match)")
                    x = np.tile(np.ravel(x)[0], (batch_size, 1))
                col = np.asarray(x, np.float32).reshape(batch_size, 1)
            elif isinstance(x, (list, tuple)):
                col = np.asarray(x, np.float32).reshape(-1, 1)
            else:
                raise TypeError(f"cannot interpret input of type {type(x)!r}")
            cols.append(col)
        return np.concatenate(cols, axis=1).astype(np.float32)

    def _normalize_inputs(self, xs):
        """Mixed per-column inputs (reference semantics) or one stacked
        ``(N, total)`` grid, as a float32 numpy array."""
        if (len(xs) == 1 and hasattr(xs[0], "ndim") and xs[0].ndim == 2
                and xs[0].shape[1] == self.model.total > 1):
            x = xs[0]
            if hasattr(x, "detach"):
                x = x.detach().cpu().numpy()
            xs_concat = np.asarray(x, np.float32)
        else:
            xs_concat = self.reshape_and_concat(xs)
        if xs_concat.shape[1] != self.model.total:
            raise ValueError(
                f"received {xs_concat.shape[1]} coordinate columns but the "
                f"problem has ndims+nparams={self.model.total}")
        return xs_concat

    # ------------------------------------------------------------------
    # constraints
    # ------------------------------------------------------------------
    def _concat_points(self, vals):
        """Counterpart of :meth:`reshape_and_concat` for the points a
        constraint passes to its forward closure (``_forward``,
        ``model_torch.py:451-457``): numbers are tiled to the batch (the
        largest element count), arrays whose size mismatches it are tiled
        from their first element, and tensors keep their autograd graph."""
        dtype, device = self.model.dtype, self.device
        batch = max((_numel(x) for x in vals if not _is_number(x)),
                    default=1)
        cols = []
        for x in vals:
            if _is_number(x):
                col = torch.full((batch, 1), float(x), dtype=dtype,
                                 device=device)
            else:
                x = torch.as_tensor(x, dtype=dtype, device=device)
                col = (x.reshape(-1)[0].expand(batch, 1)
                       if x.numel() != batch else x.reshape(batch, 1))
            cols.append(col)
        return torch.cat(cols, dim=1)

    def _make_forward(self, params, ctx):
        """Forward closure handed to constraints: evaluates the model at
        arbitrary points.  If any argument is a coordinate expression, the
        result is a differentiable :class:`Expr`, so ``D`` works inside
        constraints too.  ``fwd.grad(*pts, wrt=k)`` evaluates the solution's
        derivative w.r.t. coordinate column ``k`` at fixed points (Neumann
        and Robin conditions); ``wrt`` also takes a multi-index tuple, e.g.
        ``wrt=(0, 0)`` for the second derivative."""
        model = self.model

        def fwd(*pts):
            if any(isinstance(p, Expr) for p in pts):
                def fn():
                    vals = [p.value if isinstance(p, Expr) else p
                            for p in pts]
                    return model.apply(params, self._concat_points(vals))
                return Expr(fn, ctx)
            return model.apply(params, self._concat_points(list(pts)))

        def fwd_grad(*pts, wrt=0):
            xs_c = self._concat_points(
                [p.value if isinstance(p, Expr) else p for p in pts])
            multi = ((wrt,) if isinstance(wrt, (int, np.integer))
                     else tuple(wrt))
            cols = [xs_c[:, k:k + 1].detach().requires_grad_(True)
                    for k in range(xs_c.shape[1])]
            with torch.enable_grad():
                out = model.apply(params, torch.cat(cols, dim=1))
                for k in multi:
                    out = _batch_diagonal_grad(out, cols[k])
            return out

        fwd.grad = fwd_grad
        return fwd

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _build_loss_fn(self, loss_terms, criterion, use_plan=False):
        """The total loss as a function of the flat parameter vector and a
        ``(batch, total)`` batch of points: the equation term first, then
        each requested constraint as ``criterion(c, zeros((1,)))``, each
        times its weight.

        ``use_plan=True`` computes every pure field tap the equation takes
        in ONE Taylor traversal (``Model.full_taps``) and the equation reads
        them from the table; otherwise ``D`` takes nested gradients on
        per-coordinate leaves that require grad.  Both are exact.  With
        constraint terms the leaves require grad on the plan too, for ``D``
        inside a constraint.
        """
        eq_weight = dict(loss_terms).get("equation")
        nums = _constraint_terms(loss_terms, len(self.constraints))
        weights = (([eq_weight] if eq_weight is not None else [])
                   + [w for _, w in nums])
        constraints = self.constraints
        model = self.model
        equation = self.equation
        total = model.total
        spec = _FlatSpec(model.params)
        plan_derivs = self._plan_derivs if use_plan else None
        leaf_grad = plan_derivs is None or bool(nums)

        def loss_fn(theta, pts):
            params = spec.unflatten(theta)
            if leaf_grad:
                leaves = [pts[:, k:k + 1].detach().requires_grad_(True)
                          for k in range(total)]
            else:
                leaves = [pts[:, k:k + 1] for k in range(total)]
            terms = []
            with variable_scope("read", params["variables"]):
                table = (model.full_taps(params, pts, plan_derivs)
                         if plan_derivs is not None else None)
                ctx = EvalContext(leaves, table=table)
                f = Expr(lambda: model.apply_leaves(params, ctx.leaves), ctx,
                         deriv=())
                coords = [Expr(_leaf_fn(ctx, k), ctx, leaf_index=k)
                          for k in range(total)]
                if eq_weight is not None:
                    acc = theta.new_zeros(())
                    for res in _as_residual_list(equation(f, *coords)):
                        acc = acc + criterion(as_array(res),
                                              torch.zeros_like(leaves[0]))
                    terms.append(acc)
                if nums:
                    fwd = self._make_forward(params, ctx)
                    zero = theta.new_zeros((1,))
                    for num, _ in nums:
                        c = as_array(constraints[num](fwd, *coords))
                        terms.append(criterion(c, zero))
            if not terms:   # only unknown names: a zero loss
                return theta[:0].sum()
            loss = theta.new_zeros(())
            for w, t in zip(weights, terms):
                loss = loss + w * t
            return loss

        loss_fn.spec = spec
        return loss_fn

    def _sample(self, sampler, n, batch_size):
        """``(n, batch_size, total)`` collocation points on the device: the
        default U(0, 1) quirk and samplers with a device path draw from the
        Solver's generator; the others on the host."""
        total = self.model.total
        if sampler is None:
            # Reference quirk: U(0, 1) per column, ignoring `domain`.
            return torch.rand((n, batch_size, total),
                              generator=self._generator, device=self.device,
                              dtype=self.model.dtype)
        if getattr(sampler, "supports_device", False):
            pts = sampler.sample_device(self._generator, n * batch_size)
            return pts.to(self.model.dtype).reshape(n, batch_size, total)
        pts = np.asarray(sampler.sample(n * batch_size), np.float32)
        return torch.as_tensor(pts, dtype=self.model.dtype,
                               device=self.device).reshape(n, batch_size,
                                                           total)

    def _flat_mask(self, spec):
        """The trainable mask as a flat float vector in ``spec``'s order,
        or None when everything trains."""
        mask = self.model.trainable_mask(self.model.params)
        leaves = _tree_leaves(mask)
        if all(m for _, m in leaves):
            return None
        assert [p for p, _ in leaves] == spec.paths
        return torch.cat([
            torch.full((int(np.prod(shape)),), float(m),
                       dtype=self.model.dtype, device=self.device)
            for (_, m), shape in zip(leaves, spec.shapes)])

    def fit(self, niters, batch_size, sampler=None, loss_terms="equation",
            optimizer="Adam", criterion="MSELoss", lr=0.005, losses=None,
            progress="auto", chunk_size=500, resample=True, fast_taps="auto",
            stop_on_nan=True, until_loss=None, **kwargs):
        """Train for ``niters`` iterations of ``batch_size`` collocation
        points each (``model_torch.py:364-422``).

        ``sampler`` is None (the default U(0, 1) quirk, on the device), a
        sampler of :mod:`pydens_tpu_torch.samplers` (drawn on the device
        when it has a device path) or any object with the host protocol
        ``sample(size) -> (size, total)``; ``resample=False`` draws ONE
        batch and trains on it every iteration.  ``loss_terms`` (alias
        ``losses``) is ``'equation'`` and/or ``'constraint_k'`` names, or a
        ``{term: weight}`` dict; ``optimizer`` is ``'Adam'`` or ``None`` to
        reuse the previous fit's optimizer and its state; ``criterion`` a
        name, a torch criterion instance or a callable; extra kwargs go to
        the optimizer (``betas``, ``eps``).  ``fast_taps``:
        ``'auto'``/``True``/``'always'`` use the Taylor plan whenever the
        equation's derivatives allow it, ``False``/``'never'`` force nested
        gradients.  ``chunk_size`` iterations run between host reads of the
        loss buffer.  Frozen layers and variables
        (``model.freeze_trainable``) have their gradient entries zeroed
        before the optimizer.

        ``stop_on_nan=True`` (the default) arms a divergence guard: at the
        first non-finite loss the rest of the chunk's updates become no-ops
        on the device (the offending iteration's own update is kept), the
        fit stops with a warning naming the iteration, the partial loss
        history (including the offending value) is kept, and
        ``history[-1]['stopped_on_nan']`` records the index.
        ``until_loss=tol`` stops the same way at the first loss at or below
        ``tol`` (``history[-1]['converged_at']``); it implies the guard.
        Every fit appends a record to :attr:`history`.
        """
        fit_t0 = time.perf_counter()
        not_ported = sorted(set(kwargs) & set(_FIT_NOT_PORTED))
        if not_ported:
            raise NotImplementedError(
                f"fit options {not_ported} are not ported to "
                "pydens_tpu_torch yet (ROADMAP.md, Queue 1 items "
                f"{sorted({_FIT_NOT_PORTED[k] for k in not_ported})})")
        niters = int(niters)
        if niters <= 0:
            return self
        if until_loss is not None:
            until_loss = float(until_loss)
            stop_on_nan = True
        if losses is not None:
            loss_terms = losses
        loss_terms = _normalize_loss_terms(loss_terms)
        criterion_fn, _ = resolve_criterion(criterion)
        if optimizer is not None:
            self._opt = resolve_optimizer(optimizer, lr, kwargs)
            self._opt_state = None
        elif self._opt is None:
            raise ValueError("fit(optimizer=None) requires a previous fit "
                             "call that created an optimizer")
        if fast_taps not in (True, False, "auto", "never", "always"):
            raise ValueError(
                f"fast_taps={fast_taps!r} is not a recognized value; use "
                "'auto' or True/'always' (Taylor plan when valid), or "
                "False/'never' (nested gradients)")
        use_plan = bool(self._plan_ok) and fast_taps not in (False, "never")

        loss_fn = self._build_loss_fn(loss_terms, criterion_fn, use_plan)
        spec = loss_fn.spec
        mask = self._flat_mask(spec)
        theta = spec.flatten(self.model.params).detach().clone()
        theta.requires_grad_(True)
        if self._opt_state is None:
            self._opt_state = self._opt.init(theta.detach())
        batch_size = int(batch_size)
        chunk = max(1, min(niters, int(chunk_size)))
        loss_buf = torch.empty((chunk,), dtype=self.model.dtype,
                               device=self.device)
        fixed = None if resample else self._sample(sampler, 1, batch_size)[0]
        # The guard's predicate, the same on the device and on the host:
        # a loss is good when finite and above tol (-inf without until_loss).
        tol = np.float32(-np.inf if until_loss is None else until_loss)
        armed = None
        if stop_on_nan:
            armed = torch.ones((), dtype=torch.bool, device=self.device)

        bounds = range(0, niters, chunk)
        if progress is True or (progress == "auto" and sys.stderr.isatty()):
            try:
                from tqdm import tqdm
                bounds = tqdm(bounds, unit="chunk")
            except ImportError:
                pass
        fit_losses = []
        iters_run = 0
        nan_stop = converged_at = None
        try:
            for start in bounds:
                n = min(chunk, niters - start)
                pts_all = (self._sample(sampler, n, batch_size) if resample
                           else None)
                for i in range(n):
                    pts = pts_all[i] if resample else fixed
                    loss = loss_fn(theta, pts)
                    grad, = torch.autograd.grad(loss, theta)
                    if mask is not None:
                        grad = grad * mask
                    loss = loss.detach()
                    # The update of the iteration that trips the guard is
                    # kept; every later one is a no-op.
                    self._opt.update(theta, grad, self._opt_state, gate=armed)
                    if armed is not None:
                        # tol < loss < inf: finite and above tol, in fewer
                        # device ops than isfinite's four.
                        armed = armed & (loss > float(tol)) & (loss < np.inf)
                    loss_buf[i] = loss
                # The one host read of this chunk.
                chunk_losses = loss_buf[:n].tolist()
                if stop_on_nan:
                    arr = np.asarray(chunk_losses, np.float32)
                    bad = ~(np.isfinite(arr) & (arr > tol))
                    if bad.any():
                        done = int(np.argmax(bad)) + 1
                        fit_losses.extend(chunk_losses[:done])
                        iters_run = start + done
                        stop_at = self._step_counter + iters_run - 1
                        if until_loss is not None and np.isfinite(
                                arr[done - 1]):
                            converged_at = stop_at
                            break
                        nan_stop = stop_at
                        warnings.warn(
                            f"fit stopped early: non-finite loss at "
                            f"iteration {nan_stop} (of {niters}); the "
                            "partial loss history is kept. Lower the "
                            "learning rate or check the sampled "
                            "domain. Pass stop_on_nan=False to "
                            "disable this guard.")
                        break
                fit_losses.extend(chunk_losses)
                iters_run = start + n
        finally:
            self._step_counter += iters_run
            self.model.load_params(spec.unflatten(theta.detach()))
            self.losses.extend(fit_losses)

        self.history.append({
            "niters": iters_run, "batch_size": batch_size,
            "optimizer": (optimizer if isinstance(optimizer, str)
                          else "reused" if optimizer is None
                          else type(optimizer).__name__),
            "lr": (lr if isinstance(lr, (int, float))
                   else getattr(lr, "__name__", "schedule")),
            "loss_terms": list(loss_terms),
            "resample": bool(resample),
            "wall_time_s": time.perf_counter() - fit_t0,
            "first_loss": float(fit_losses[0]),
            "final_loss": float(fit_losses[-1]),
        })
        if nan_stop is not None:
            self.history[-1]["stopped_on_nan"] = int(nan_stop)
        if converged_at is not None:
            self.history[-1]["converged_at"] = int(converged_at)
        return self

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def predict(self, *xs):
        """Evaluate the trained solution at the supplied points: arrays,
        numbers (tiled to the batch), lists, or one ``(N, ndims+nparams)``
        array of stacked coordinates.  Returns an ``(N, n_out)`` numpy
        array."""
        x = torch.as_tensor(self._normalize_inputs(xs),
                            dtype=self.model.dtype, device=self.device)
        out = self.model.predict_apply(self.model.params, x)
        return out.cpu().numpy()
