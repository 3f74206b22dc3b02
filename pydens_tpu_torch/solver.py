"""Solver: trains a neural network to satisfy a differential equation.

Counterpart of ``pydens_tpu/solver.py`` with the same public surface for the
ported slice (``__init__`` / ``fit`` / ``predict`` / ``reshape_and_concat``
/ ``.losses`` / ``.model``) and the same reference quirks:

* ``V``-token variables are discovered by a fake run of model + equation
  at construction (``model_torch.py:319-325``) — here a real forward on one
  row, which also records the equation's derivative plan.
* Training state is ONE flat parameter vector; the network sees views into
  it.  Each step is a loss, one ``torch.autograd.grad`` and an in-place
  optimizer update, all on the device, in one closure over buffers that
  live as long as the fit configuration is cached (:class:`_FitStep`): on
  the card the first step of a configuration runs eagerly and every later
  one replays a captured CUDA graph of it, the port's counterpart of the
  JAX package's one compiled chunk.  Losses go into a device buffer that
  the host reads once per chunk.
* The default sampler is U(0, 1) per column and IGNORES ``domain``
  (``model_torch.py:431``), drawn on the device from the Solver's
  ``torch.Generator`` once per chunk; so is any sampler with a device path
  (``sample_device``).  Host-only samplers are drawn on the host.
* Constraints run in the discovery run too, in a context of their own, so
  a ``V`` used only in a constraint is trained and the derivative plan is
  the equation's alone.
"""

from __future__ import annotations

import contextlib
import gc
import os
import re
import sys
import time
import traceback
import warnings

import numpy as np
import torch

from .models import ConvBlockModel
from .models.base import resolve_device
from .ops.tokens import (Expr, EvalContext, _batch_diagonal_grad,
                         as_array, as_device, staging, variable_scope)
from .utils.criteria import resolve_criterion
from .utils.optimizers import LBFGS, LMConfig, resolve_optimizer

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
_FIT_NOT_PORTED = {"adaptive": 10, "rba": 10, "causal": 10,
                   "causal_axis": 10, "loss_balancing": 10}


def _capture_error(err):
    """The first error of a failed capture (a failing op makes the end of
    the capture fail too) and the innermost frame outside torch that led to
    it, as ``file:line (function)``."""
    while err.__context__ is not None and isinstance(err.__context__,
                                                     RuntimeError):
        err = err.__context__
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if f"{os.sep}torch{os.sep}" not in f.filename]
    site = (f"{frames[-1].filename}:{frames[-1].lineno} ({frames[-1].name})"
            if frames else "unknown site")
    return err, site


class _FitStep:
    """One fit configuration's training step, in place, as a closure over
    buffers that live as long as the configuration stays cached: the flat
    parameters ``theta``, the optimizer ``state``, the guard flag ``armed``
    and its threshold ``tol``, the device step ``index`` (0-d int64), the
    chunk's ``points`` ``(chunk, batch, total)`` (one row with
    ``resample=False``) and the ``losses`` buffer.  The points row and the
    loss slot are picked by the device index, so the step has no Python
    state and no host read (counterpart of ``run_chunk``'s ``body``,
    ``pydens_tpu/solver.py:1205-1450``).

    :meth:`run` takes steps: eagerly on the CPU, or when ``capture`` is off;
    on the card the configuration's first step runs eagerly on a side
    stream (the warm-up, a real step), the next one captures the closure as
    a CUDA graph, and every step from then on replays it.  Host values the
    step reads are staged on the device by the warm-up
    (:func:`~pydens_tpu_torch.ops.tokens.staging`).  A capture that fails
    raises with its first error and the site; nothing falls back.

    With :class:`~pydens_tpu_torch.utils.optimizers.LMConfig` a step is one
    Levenberg-Marquardt update of the residual vector (``loss_fn.resvec``),
    its conjugate-gradient loop a fixed trip count in the graph; ``live``
    sums the live CG iterations on the device."""

    def __init__(self, loss_fn, opt, mask, theta, chunk, batch_size,
                 resample, guard, capture):
        dev, dtype = theta.device, theta.dtype
        total = loss_fn.total
        self.loss_fn = loss_fn
        self.opt = opt
        self.mask = mask
        self.theta = theta.detach().clone().requires_grad_(True)
        self.state = opt.init(self.theta.detach())
        self.armed = (torch.ones((), dtype=torch.bool, device=dev)
                      if guard else None)
        self.tol = (torch.full((), -np.inf, dtype=dtype, device=dev)
                    if guard else None)
        self.index = torch.zeros((), dtype=torch.int64, device=dev)
        self.resample = resample
        self.points = torch.zeros((chunk if resample else 1, batch_size,
                                   total), dtype=dtype, device=dev)
        self.losses = torch.zeros((chunk,), dtype=dtype, device=dev)
        self.live = torch.zeros((), dtype=torch.int64, device=dev)
        self.capture = capture
        self.graph = None
        self.constants = {}
        self.eager_steps = 0     # steps run eagerly (the warm-up, or all)
        self.replays = 0         # steps run as replays of the graph

    def _points_row(self):
        if self.resample:
            return self.points.index_select(0, self.index)[0]
        return self.points[0]

    def _record(self, loss):
        """The guard's flag, the loss slot and the index after a step whose
        loss at the start was ``loss``."""
        if self.armed is not None:
            # tol < loss < inf: finite and above tol, in fewer device ops
            # than isfinite's four.
            self.armed.logical_and_((loss > self.tol) & (loss < np.inf))
        self.losses.index_copy_(0, self.index, loss)
        self.index.add_(1)

    def step(self):
        """One training step; reads and writes only the buffers above.  The
        update of the iteration that trips the guard is kept; every later
        one is a no-op."""
        pts = self._points_row()
        if isinstance(self.opt, LMConfig):
            loss, live = self.opt.update(
                self.theta, lambda th: self.loss_fn.resvec(th, pts),
                self.state, mask=self.mask, gate=self.armed)
            self.live.add_(live)
        else:
            loss = self.loss_fn(self.theta, pts)
            grad, = torch.autograd.grad(loss, self.theta)
            if self.mask is not None:
                grad = grad * self.mask
            loss = loss.detach()
            self.opt.update(self.theta, grad, self.state, gate=self.armed)
        self._record(loss)

    def run(self, n):
        """Take ``n`` steps from the device index 0.  If one raises (a
        capture that fails), ``theta`` and the state are put back as they
        were before the first, so the fit commits the last whole chunk."""
        buffers = (self.theta, *self.state.values())
        saved = [t.detach().clone() for t in buffers]
        self.index.zero_()
        try:
            for _ in range(n):
                self._one_step()
        except BaseException:
            with torch.no_grad():
                for dst, src in zip(buffers, saved):
                    dst.copy_(src)
            raise

    def _one_step(self):
        if not self.capture:
            self.step()
            self.eager_steps += 1
        elif not self.eager_steps:
            self._warm_up(self.step)
            self.eager_steps += 1
        else:
            if self.graph is None:
                self.graph = self._capture(self.step)
            self.graph.replay()
            self.replays += 1

    def _warm_up(self, fn):
        dev = self.theta.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with staging(self.constants), torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(dev).wait_stream(side)

    def _capture(self, fn):
        # Capture records fn without running it: theta, the state and the
        # index move only when the graph is replayed.  The cyclic garbage
        # collector is held off meanwhile: collecting a dead solver there
        # frees its graphs and their memory, which invalidates the capture.
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with staging(self.constants), torch.cuda.graph(graph):
                fn()
        except RuntimeError as err:
            first, site = _capture_error(err)
            raise RuntimeError(
                f"CUDA-graph capture of the fit step failed at {site}: "
                f"{first}. A step must not read a device value on the host "
                "(.item(), float(), .tolist(), a Python `if` on a tensor), "
                "e.g. in an equation, a condition or an lr schedule") from err
        finally:
            if collecting:
                gc.enable()
        return graph


class _LinesearchFitStep(_FitStep):
    """The L-BFGS step (:class:`~pydens_tpu_torch.utils.optimizers.LBFGS`):
    the value and gradient at ``theta``, the direction and the first
    linesearch trial (:meth:`step`), then one trial at a time
    (:meth:`trial`) while the linesearch's ``active`` flag, which the host
    reads after each, holds.  On the card each of the two is a captured
    graph (``graph`` and ``trial_graph``); the configuration's first step
    and its trials run eagerly as the warm-up.  Every trial evaluates the
    loss and its gradient on the step's points (``step_points``); ``live``
    sums the trials on the device.

    ``masked`` puts every trial a step may take (``max_linesearch_steps``,
    each a no-op once the search has ended) into the one step graph, which
    then needs no host read (the design timed against this one)."""

    def __init__(self, *args, masked=False):
        super().__init__(*args)
        self.ls = self.opt.scratch(self.theta.detach())
        self.step_points = torch.zeros_like(self.points[0])
        self.masked = masked
        self.trial_graph = None
        self.eager_trials = 0    # trials after a step's first, run eagerly
        self.trial_replays = 0   # and as replays of the trial graph

    def _value_and_grad(self, point):
        point = point.detach().requires_grad_(True)
        loss = self.loss_fn(point, self.step_points)
        grad, = torch.autograd.grad(loss, point)
        return loss.detach(), grad

    def trial(self):
        was = self.opt.trial(self.theta, self.state, self.ls,
                             self._value_and_grad)
        self.live.add_(was.to(torch.int64))

    def step(self):
        with torch.no_grad():
            self.step_points.copy_(self._points_row())
        loss = self.loss_fn(self.theta, self.step_points)
        grad, = torch.autograd.grad(loss, self.theta)
        if self.mask is not None:
            grad = grad * self.mask
        loss = loss.detach()
        self.opt.begin(self.theta.detach(), loss, grad, self.state, self.ls,
                       gate=self.armed)
        trials = (self.opt.linesearch.max_linesearch_steps if self.masked
                  else 1)
        for _ in range(trials):
            self.trial()
        self._record(loss)

    def _eager_step(self):
        self.step()
        while bool(self.ls["active"]):
            self.trial()
            self.eager_trials += 1

    def _one_step(self):
        if self.masked:
            return super()._one_step()
        if not self.capture:
            self._eager_step()
            self.eager_steps += 1
            return
        if not self.eager_steps:
            self._warm_up(self._eager_step)
            self.eager_steps += 1
            return
        if self.graph is None:
            self.graph = self._capture(self.step)
        self.graph.replay()
        self.replays += 1
        while bool(self.ls["active"]):   # the one host read of a trial
            if self.trial_graph is None:
                self.trial_graph = self._capture(self.trial)
            self.trial_graph.replay()
            self.trial_replays += 1


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
        Where parameters live and training runs; default the CUDA card
        (an error without one: pass ``device="cpu"`` for the CPU).
    """

    # False runs every step on the card eagerly, for comparisons with the
    # captured graph only: no fit argument reaches it.
    _capture_steps = True
    # True captures every linesearch trial an L-BFGS step may take in its
    # graph, for the comparison of the two designs only (_LinesearchFitStep).
    _masked_linesearch = False

    def __init__(self, equation, ndims, initial_condition=None,
                 boundary_condition=None, domain=(0, 1), nparams=0,
                 model=ConvBlockModel, constraints=None, seed=0, device=None,
                 mesh=None, n_models=1, formulation="residual", **kwargs):
        # pydens_tpu's defaults are taken; any other value is a feature of
        # a later slice (ROADMAP.md Queue 1 item).
        for name, value, default, item in (
                ("formulation", formulation, "residual", 10),
                ("n_models", n_models, 1, 11), ("mesh", mesh, None, 15)):
            if value is not default and value != default:
                raise NotImplementedError(
                    f"Solver({name}={value!r}) is not ported to "
                    f"pydens_tpu_torch yet (ROADMAP.md, Queue 1 item {item})")
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
        self._init_generator = torch.Generator().manual_seed(seed)
        self.model.reset_parameters(self._init_generator)
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self._opt = None
        self._opt_state = None
        self._pending_opt_state = None   # set by a checkpoint load
        self._opt_cache = {}
        self._step_cache = {}

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
        # Copies: on the CPU the variables share the registry's memory.
        self._initial_variables = {k: np.array(v) for k, v in
                                   registry.items()}

    @property
    def params(self):
        """The full parameter tree (net + log_scale + V variables)."""
        return self.model.params

    def reset(self, seed=None):
        """Re-initialize the parameters and V variables as ``__init__``
        does, and clear the loss history, the fit history, the optimizer
        and its state and the step counter, keeping the cached fit steps
        (and their CUDA graphs), so a following ``fit`` with the same
        configuration replays its graph.  With ``seed``, the parameters
        equal those of a new ``Solver(..., seed=seed)`` and the sampling
        generator restarts from ``seed``; without, both continue their
        streams, so the parameters are new."""
        if seed is not None:
            self._init_generator.manual_seed(int(seed))
            self._generator.manual_seed(int(seed))
        self.model.reset_parameters(self._init_generator)
        with torch.no_grad():
            for name, value in self._initial_variables.items():
                self.model.variables[name].copy_(torch.as_tensor(value))
        self.losses = []
        self.history = []
        self._opt = None
        self._opt_state = None
        self._pending_opt_state = None
        self._step_counter = 0
        return self

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
                x = as_device(x, device, dtype)
                col =(x.reshape(-1)[0].expand(batch, 1)
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

        def term_values(theta, pts):
            """The equation's residuals (None without an equation term) and
            the requested constraints' values at ``theta``."""
            params = spec.unflatten(theta)
            if leaf_grad:
                leaves = [pts[:, k:k + 1].detach().requires_grad_(True)
                          for k in range(total)]
            else:
                leaves = [pts[:, k:k + 1] for k in range(total)]
            residuals, values = None, []
            with variable_scope("read", params["variables"]):
                table = (model.full_taps(params, pts, plan_derivs)
                         if plan_derivs is not None else None)
                ctx = EvalContext(leaves, table=table)
                f = Expr(lambda: model.apply_leaves(params, ctx.leaves), ctx,
                         deriv=())
                coords = [Expr(_leaf_fn(ctx, k), ctx, leaf_index=k)
                          for k in range(total)]
                if eq_weight is not None:
                    residuals = [as_array(res) for res in
                                 _as_residual_list(equation(f, *coords))]
                if nums:
                    fwd = self._make_forward(params, ctx)
                    values = [as_array(constraints[num](fwd, *coords))
                              for num, _ in nums]
            return residuals, values, leaves[0]

        def loss_fn(theta, pts):
            residuals, values, leaf = term_values(theta, pts)
            terms = []
            if residuals is not None:
                acc = theta.new_zeros(())
                for res in residuals:
                    acc = acc + criterion(res, torch.zeros_like(leaf))
                terms.append(acc)
            if values:
                zero = theta.new_zeros((1,))
                terms += [criterion(c, zero) for c in values]
            if not terms:   # only unknown names: a zero loss
                return theta[:0].sum()
            loss = theta.new_zeros(())
            for w, t in zip(weights, terms):
                loss = loss + w * t
            return loss

        def resvec(theta, pts):
            """The stacked residual vector ``r`` with ``loss_fn == r . r``
            for the MSE criterion: each block flattened and scaled by
            ``sqrt(weight / size)`` (``resvec_fn`` of
            ``pydens_tpu/solver.py``), for Levenberg-Marquardt."""
            residuals, values, _ = term_values(theta, pts)
            blocks = [res.reshape(-1) * (eq_weight / res.numel()) ** 0.5
                      for res in residuals or ()]
            blocks += [c.reshape(-1) * (w / c.numel()) ** 0.5
                       for c, (_, w) in zip(values, nums)]
            if not blocks:
                return theta.new_zeros((1,))
            return torch.cat(blocks)

        loss_fn.spec = spec
        loss_fn.total = total
        loss_fn.resvec = resvec
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
            progress="auto", chunk_size=500, profile_dir=None, resample=True,
            fast_taps="auto", callback=None, checkpoint_path=None,
            checkpoint_every=None, stop_on_nan=True, until_loss=None,
            **kwargs):
        """Train for ``niters`` iterations of ``batch_size`` collocation
        points each (``model_torch.py:364-422``).

        ``sampler`` is None (the default U(0, 1) quirk, on the device), a
        sampler of :mod:`pydens_tpu_torch.samplers` (drawn on the device
        when it has a device path) or any object with the host protocol
        ``sample(size) -> (size, total)``; ``resample=False`` draws ONE
        batch and trains on it every iteration.  ``loss_terms`` (alias
        ``losses``) is ``'equation'`` and/or ``'constraint_k'`` names, or a
        ``{term: weight}`` dict; ``optimizer`` is a torch-style name
        (``'Adam'``, ``'AdamW'``, ``'Adamax'``, ``'NAdam'``, ``'RAdam'``,
        ``'SGD'``, ``'RMSprop'``, ``'Adagrad'``, ``'Adadelta'``,
        ``'Lion'``; the finishers ``'LBFGS'``, with a zoom linesearch, and
        ``'LM'`` / ``'GaussNewton'``, matrix-free Levenberg-Marquardt on the
        residual vector, MSE criterion only), an optimizer object, a factory
        ``f(learning_rate=lr, **kwargs)``, or ``None`` to reuse the previous
        fit's optimizer and its state; extra kwargs go to the optimizer
        (``betas``, ``eps``, ``momentum``, ``weight_decay``, ``memory_size``,
        ``cg_iters``, ...).  ``lr`` is a float or a
        schedule of :mod:`pydens_tpu_torch.utils.schedules` (any function
        of the 0-d device step count written in torch ops).  ``criterion``
        is a name, a torch criterion instance or a callable.
        ``fast_taps``: ``'auto'``/``True``/``'always'`` use the Taylor plan
        whenever the equation's derivatives allow it, ``False``/``'never'``
        force nested gradients.  Frozen layers and variables
        (``model.freeze_trainable``) have their gradient entries zeroed
        before the optimizer.

        ``chunk_size`` iterations run between host reads of the loss
        buffer.  On the card every step after a configuration's first
        replays a captured CUDA graph of the step (one launch a step); the
        graph is cached per configuration (loss terms, criterion,
        optimizer and learning rate, batch and chunk size, plan, frozen
        names, ``resample``, guard), so a later fit of the same
        configuration, ``fit(optimizer=None)`` and a fit after
        :meth:`reset` replay it.  A step that cannot be captured raises.

        ``callback(iteration, chunk_losses)`` is called after every chunk
        with the global iteration count and that chunk's losses (a float32
        array); a truthy return stops the fit cleanly.  If it raises, what
        completed is kept.  ``checkpoint_path`` snapshots the training
        state (as :meth:`save`) every ``checkpoint_every`` iterations
        (default: every chunk), at chunk boundaries, and at the end of the
        fit, a callback stop included but not a stop at a non-finite loss.
        ``profile_dir`` writes a ``torch.profiler`` trace of the whole fit
        there (``fit_<time>.pt.trace.json``, for ``chrome://tracing`` or
        TensorBoard).

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
            items = sorted({_FIT_NOT_PORTED[k] for k in not_ported})
            raise NotImplementedError(
                f"fit options {not_ported} are not ported to "
                "pydens_tpu_torch yet (ROADMAP.md, Queue 1 item "
                f"{', '.join(map(str, items))})")
        niters = int(niters)
        if niters <= 0:
            return self
        if until_loss is not None:
            until_loss = float(until_loss)
            stop_on_nan = True
        if losses is not None:
            loss_terms = losses
        loss_terms = _normalize_loss_terms(loss_terms)
        criterion_fn, criterion_key = resolve_criterion(criterion)
        fresh_optimizer = optimizer is not None
        if fresh_optimizer:
            # One instance per (optimizer, lr, kwargs), as the JAX package
            # keys it (a schedule by identity): the cached fit steps key on
            # the instance.  The entry keeps the optimizer and lr objects
            # alive, so an id in the token is never reused.
            opt_token = (optimizer if isinstance(optimizer, str)
                         else id(optimizer),
                         float(lr) if isinstance(lr, (int, float))
                         else id(lr),
                         tuple(sorted(kwargs.items())))
            if opt_token not in self._opt_cache:
                self._opt_cache[opt_token] = (
                    resolve_optimizer(optimizer, lr, kwargs), optimizer, lr)
            self._opt = self._opt_cache[opt_token][0]
        elif self._opt is None:
            raise ValueError("fit(optimizer=None) requires a previous fit "
                             "call that created an optimizer")
        if fast_taps not in (True, False, "auto", "never", "always"):
            raise ValueError(
                f"fast_taps={fast_taps!r} is not a recognized value; use "
                "'auto' or True/'always' (Taylor plan when valid), or "
                "False/'never' (nested gradients)")
        use_plan = bool(self._plan_ok) and fast_taps not in (False, "never")
        if isinstance(self._opt, LMConfig):
            self._check_lm(criterion_key)
        batch_size = int(batch_size)
        chunk = max(1, min(niters, int(chunk_size)))
        step = self._fit_step(loss_terms, criterion_fn, use_plan, batch_size,
                              chunk, bool(resample), bool(stop_on_nan))
        spec = step.loss_fn.spec
        with torch.no_grad():
            step.theta.copy_(spec.flatten(self.model.params))
        if fresh_optimizer or self._opt_state is None:
            self._opt_state = self._opt.init(step.theta.detach())
        for name, value in self._opt_state.items():
            step.state[name].copy_(value)
        self._graft_pending_opt_state(step.state)
        # The guard's predicate, the same on the device and on the host:
        # a loss is good when finite and above tol (-inf without until_loss).
        tol = np.float32(-np.inf if until_loss is None else until_loss)
        if step.armed is not None:
            step.armed.fill_(True)
            step.tol.fill_(float(tol))
        if not resample:
            step.points[0].copy_(self._sample(sampler, 1, batch_size)[0])

        bounds = range(0, niters, chunk)
        if progress is True or (progress == "auto" and sys.stderr.isatty()):
            try:
                from tqdm import tqdm
                bounds = tqdm(bounds, unit="chunk")
            except ImportError:
                pass
        profiler = contextlib.nullcontext()
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile
            profiler = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda"
                else []))
        ckpt_every = int(checkpoint_every or chunk)
        ckpt_saved = -1
        fit_losses = []
        iters_run = 0
        nan_stop = converged_at = None

        def save_checkpoint():
            # Host copies of the step's buffers between chunks: a snapshot
            # never reads them inside a step.
            nonlocal ckpt_saved
            ckpt_saved = iters_run
            from .utils.checkpoint import save_solver
            save_solver(self, checkpoint_path,
                        params=spec.unflatten(step.theta.detach()),
                        opt_state=step.state,
                        losses=self.losses + fit_losses,
                        step_counter=self._step_counter + iters_run)

        try:
            with profiler:
                for start in bounds:
                    n = min(chunk, niters - start)
                    if resample:
                        step.points[:n].copy_(
                            self._sample(sampler, n, batch_size))
                    step.run(n)
                    # The one host read of this chunk.
                    chunk_losses = step.losses[:n].tolist()
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
                    if checkpoint_path is not None and (
                            iters_run // ckpt_every
                            > max(ckpt_saved, 0) // ckpt_every):
                        save_checkpoint()
                    if callback is not None and callback(
                            self._step_counter + iters_run,
                            np.asarray(chunk_losses, np.float32)):
                        break
            # The final snapshot: at the end of the fit or a callback stop,
            # whatever the interval; a non-finite stop keeps the last good
            # one.
            if (checkpoint_path is not None and nan_stop is None
                    and ckpt_saved < iters_run):
                save_checkpoint()
        finally:
            # Commit whatever completed, also when a callback raised.
            self._step_counter += iters_run
            self.model.load_params(spec.unflatten(step.theta.detach()))
            self._opt_state = {k: v.clone() for k, v in step.state.items()}
            self.losses.extend(fit_losses)
            if profile_dir:
                os.makedirs(profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(
                    profile_dir, f"fit_{time.time_ns()}.pt.trace.json"))

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

    def _check_lm(self, criterion_key):
        """Levenberg-Marquardt's condition (``pydens_tpu``'s ``fit``): the
        MSE criterion, so that ``loss == |r|^2``."""
        if (isinstance(criterion_key, str)
                and criterion_key not in ("mseloss", "mse")):
            raise ValueError(
                "optimizer='LM' (Gauss-Newton) is defined for the MSE "
                "criterion (loss == ||residual||^2)")

    def _fit_step(self, loss_terms, criterion_fn, use_plan, batch_size,
                  chunk, resample, guard):
        """The cached :class:`_FitStep` of a fit configuration, built on
        first use.  The optimizer instance is part of the key, and with it
        its float learning rate (baked into a captured graph) or its
        schedule."""
        capture = self.device.type == "cuda" and self._capture_steps
        masked = self._masked_linesearch
        key = (loss_terms, criterion_fn, self._opt, use_plan, batch_size,
               chunk, resample, guard, capture, masked,
               frozenset(self.model._frozen_layers),
               frozenset(self.model._frozen_variables))
        if key not in self._step_cache:
            loss_fn = self._build_loss_fn(loss_terms, criterion_fn, use_plan)
            args = (loss_fn, self._opt, self._flat_mask(loss_fn.spec),
                    loss_fn.spec.flatten(self.model.params), chunk,
                    batch_size, resample, guard, capture)
            self._step_cache[key] = (
                _LinesearchFitStep(*args, masked=masked)
                if isinstance(self._opt, LBFGS) else _FitStep(*args))
        return self._step_cache[key]

    def _graft_pending_opt_state(self, state):
        """Checkpoint resume: the loaded optimizer state replaces this
        fit's, if it has the same buffers (``pydens_tpu``'s
        ``_pending_opt_state``)."""
        pending, self._pending_opt_state = self._pending_opt_state, None
        if pending is None:
            return
        if set(pending) != set(state) or any(
                tuple(pending[k].shape) != tuple(state[k].shape)
                for k in state):
            warnings.warn(
                "checkpointed optimizer state is incompatible with this "
                f"fit's optimizer and was not restored: buffers "
                f"{sorted(pending)} vs {sorted(state)}")
            return
        for name, value in pending.items():
            state[name].copy_(torch.as_tensor(value))

    # ------------------------------------------------------------------
    # checkpointing (a superset of the reference, which has none)
    # ------------------------------------------------------------------
    def save(self, path):
        """Write the parameters (V variables included), the optimizer
        state, the losses, the step counter, the sampling generator's
        state, the fit history, the condition modes and the frozen names
        to ``path`` (:mod:`pydens_tpu_torch.utils.checkpoint`)."""
        from .utils.checkpoint import save_solver
        save_solver(self, path)

    def load(self, path):
        """Restore a checkpoint written by :meth:`save` into this solver
        (built with the same problem and model configuration).  The
        optimizer state is grafted onto the next fit's optimizer."""
        from .utils.checkpoint import load_solver
        load_solver(self, path)
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
