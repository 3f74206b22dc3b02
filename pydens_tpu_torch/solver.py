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
  ``torch.Generator`` once per chunk.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .models import ConvBlockModel
from .models.base import resolve_device
from .ops.tokens import Expr, EvalContext, variable_scope, as_array
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


def _is_number(x):
    return isinstance(x, (int, float, np.integer, np.floating))


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
        if constraints:
            raise NotImplementedError(
                "constraints are not ported to pydens_tpu_torch yet "
                "(ROADMAP.md, Queue 1 item 6)")
        self.equation = equation
        self.device = resolve_device(device)
        self.losses = []
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

        # Discovery: one real forward of model + equation on a single row of
        # domain midpoints registers the V variables and records which pure
        # field derivatives the equation takes (the plan).
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
    # training
    # ------------------------------------------------------------------
    def _build_loss_fn(self, loss_terms, criterion, use_plan=False):
        """The total loss as a function of the flat parameter vector and a
        ``(batch, total)`` batch of points.

        ``use_plan=True`` computes every pure field tap the equation takes
        in ONE Taylor traversal (``Model.full_taps``) and the equation reads
        them from the table; otherwise ``D`` takes nested gradients on
        per-coordinate leaves that require grad.  Both are exact.
        """
        eq_weight = dict(loss_terms).get("equation")
        model = self.model
        equation = self.equation
        total = model.total
        spec = _FlatSpec(model.params)
        plan_derivs = self._plan_derivs if use_plan else None

        def loss_fn(theta, pts):
            params = spec.unflatten(theta)
            if plan_derivs is not None:
                leaves = [pts[:, k:k + 1] for k in range(total)]
            else:
                leaves = [pts[:, k:k + 1].detach().requires_grad_(True)
                          for k in range(total)]
            loss = theta.new_zeros(())
            with variable_scope("read", params["variables"]):
                table = (model.full_taps(params, pts, plan_derivs)
                         if plan_derivs is not None else None)
                ctx = EvalContext(leaves, table=table)
                f = Expr(lambda: model.apply_leaves(params, ctx.leaves), ctx,
                         deriv=())
                coords = [Expr(_leaf_fn(ctx, k), ctx, leaf_index=k)
                          for k in range(total)]
                for res in _as_residual_list(equation(f, *coords)):
                    res = as_array(res)
                    loss = loss + eq_weight * criterion(
                        res, torch.zeros_like(leaves[0]))
            return loss

        loss_fn.spec = spec
        return loss_fn

    def _sample(self, sampler, n, batch_size):
        """``(n, batch_size, total)`` collocation points on the device."""
        total = self.model.total
        if sampler is None:
            # Reference quirk: U(0, 1) per column, ignoring `domain`.
            return torch.rand((n, batch_size, total),
                              generator=self._generator, device=self.device,
                              dtype=self.model.dtype)
        pts = np.asarray(sampler.sample(n * batch_size), np.float32)
        return torch.as_tensor(pts, dtype=self.model.dtype,
                               device=self.device).reshape(n, batch_size,
                                                           total)

    def fit(self, niters, batch_size, sampler=None, loss_terms="equation",
            optimizer="Adam", criterion="MSELoss", lr=0.005, losses=None,
            progress="auto", chunk_size=500, fast_taps="auto", **kwargs):
        """Train for ``niters`` iterations of ``batch_size`` collocation
        points each (``model_torch.py:364-422``).

        ``sampler`` is None (the default U(0, 1) quirk, on the device) or an
        object with the host protocol ``sample(size) -> (size, total)``;
        ``loss_terms`` (alias ``losses``) is ``'equation'`` or a
        ``{'equation': weight}`` dict; ``optimizer`` is ``'Adam'`` or
        ``None`` to reuse the previous fit's optimizer and its state;
        ``criterion`` a name, a torch criterion instance or a callable;
        extra kwargs go to the optimizer (``betas``, ``eps``).
        ``fast_taps``: ``'auto'``/``True``/``'always'`` use the Taylor plan
        whenever the equation's derivatives allow it, ``False``/``'never'``
        force nested gradients.  ``chunk_size`` iterations run between host
        reads of the loss buffer.
        """
        niters = int(niters)
        if niters <= 0:
            return self
        if losses is not None:
            loss_terms = losses
        if isinstance(loss_terms, dict):
            loss_terms = tuple((str(k), float(v))
                               for k, v in loss_terms.items())
        else:
            if not isinstance(loss_terms, (tuple, list)):
                loss_terms = (loss_terms,)
            loss_terms = tuple((str(t), 1.0) for t in loss_terms)
        for term, _ in loss_terms:
            if "constraint" in term:
                raise NotImplementedError(
                    "constraint loss terms are not ported to "
                    "pydens_tpu_torch yet (ROADMAP.md, Queue 1 item 6)")
        if "equation" not in dict(loss_terms):
            raise ValueError(
                f"loss_terms={loss_terms!r} has no 'equation' term, so there "
                "is nothing to train")
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
        theta = spec.flatten(self.model.params).detach().clone()
        theta.requires_grad_(True)
        if self._opt_state is None:
            self._opt_state = self._opt.init(theta.detach())
        chunk = max(1, min(niters, int(chunk_size)))
        loss_buf = torch.empty((chunk,), dtype=self.model.dtype,
                               device=self.device)

        bounds = range(0, niters, chunk)
        if progress is True or (progress == "auto" and sys.stderr.isatty()):
            try:
                from tqdm import tqdm
                bounds = tqdm(bounds, unit="chunk")
            except ImportError:
                pass
        fit_losses = []
        try:
            for start in bounds:
                n = min(chunk, niters - start)
                pts_all = self._sample(sampler, n, int(batch_size))
                for i in range(n):
                    loss = loss_fn(theta, pts_all[i])
                    grad, = torch.autograd.grad(loss, theta)
                    self._opt.update(theta, grad, self._opt_state)
                    loss_buf[i] = loss.detach()
                # The one host read of this chunk.
                fit_losses.extend(loss_buf[:n].tolist())
        finally:
            self.model.load_params(spec.unflatten(theta.detach()))
            self.losses.extend(fit_losses)
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
