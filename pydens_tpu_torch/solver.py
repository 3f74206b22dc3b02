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
from typing import NamedTuple

import numpy as np
import torch

from .models import ConvBlockModel
from .models.base import resolve_device
from .ops.tokens import (Expr, EvalContext, _batch_diagonal_grad,
                         as_array, as_device, member_scope, staging,
                         variable_scope)
from .utils.criteria import member_losses, resolve_criterion
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
    """Paths, shapes and offsets of the flat parameter vector: ``(P,)`` for
    one model, ``(K, P)`` for an ensemble of ``n_models`` members whose
    leaves carry a leading member axis (``_flatten_stacked`` of
    ``pydens_tpu``); ``shapes`` are a member's."""

    def __init__(self, tree, n_models=1):
        self.skeleton = _skeleton(tree)
        leaves = _tree_leaves(tree)
        self.lead = () if n_models == 1 else (n_models,)
        self.paths = [p for p, _ in leaves]
        self.shapes = [tuple(t.shape)[len(self.lead):] for _, t in leaves]
        sizes = [int(np.prod(s)) for s in self.shapes]
        self.offsets = np.cumsum([0] + sizes).tolist()

    def flatten(self, tree):
        return torch.cat([t.reshape(self.lead + (-1,))
                          for _, t in _tree_leaves(tree)], dim=-1)

    def unflatten(self, theta):
        """The parameter tree as views into ``theta``."""
        tree = _skeleton(self.skeleton)
        for i, path in enumerate(self.paths):
            node = tree
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = theta[
                ..., self.offsets[i]:self.offsets[i + 1]].view(
                    self.lead + self.shapes[i])
        return tree


# Rademacher probes per NTK-trace estimate (fit(loss_balancing='ntk')),
# pydens_tpu/solver.py:59-69.  A term whose residual block has at most this
# many entries enumerates its basis instead: its trace is exact.
_NTK_PROBES = 4

# Loss balancing rebalances in the fit's first 10 intervals only
# (pydens_tpu/solver.py:1305-1330).
_REBALANCES = 10


class _Collocation(NamedTuple):
    """A fit's collocation and objective options, part of its step's cache
    key: ``adaptive`` (the candidate factor, or None), ``rba`` (``(eta,
    gamma)`` or None), ``causal`` (``(time column, lo, hi)`` or None),
    ``balance_every`` (the rebalance interval; 0 is off) and
    ``balance_mode`` (``'grad'`` or ``'ntk'``)."""
    adaptive: int | None = None
    rba: tuple | None = None
    causal: tuple | None = None
    balance_every: int = 0
    balance_mode: str = "grad"

    def rebalances(self, local):
        """Whether the fit-local step ``local`` rebalances the term
        weights."""
        every = self.balance_every
        return bool(every) and local % every == 0 and local < (
            _REBALANCES * every)


def _adaptive_pick(r, u, m_pool):
    """The refinement half of an adaptive batch: indices into the candidate
    pool drawn with probability proportional to ``r`` (``(m_pool,)``), by
    the inverse CDF at the uniforms ``u``, and their importance weights
    ``1 / (m_pool p)``.  ``pydens_tpu/solver.py:1236-1262`` draws from the
    same distribution with a Gumbel categorical."""
    probs = r / (torch.sum(r) + 1e-30)
    idx = torch.searchsorted(torch.cumsum(probs, 0), u, right=True)
    idx = idx.clamp_(max=m_pool - 1)
    return idx, 1.0 / (m_pool * probs[idx] + 1e-30)


def _rba_update(rba_w, r, eta, gamma):
    """Residual-based attention's EMA of the normalized |residual| ``r``
    (``pydens_tpu/solver.py:1280-1294``)."""
    return gamma * rba_w + eta * r / (torch.max(r) + 1e-30)


def _anchored_ema(stat, wts, anchor):
    """Inverse-statistic term weights anchored at the first term's static
    weight ``anchor``, clipped to two decades around it, the anchor pinned,
    then EMA-smoothed into ``wts`` (``_anchored_ema``,
    ``pydens_tpu/solver.py:1098-1118``)."""
    lam = (stat[0] / (stat + 1e-12) * anchor).clamp(0.01 * anchor,
                                                   100.0 * anchor)
    lam = torch.cat([lam.new_full((1,), anchor), lam[1:]])
    return 0.7 * wts + 0.3 * lam


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

    The collocation options (:class:`_Collocation`) add buffers of their
    own, all written outside the step: with ``adaptive`` the points rows
    hold each step's ``adaptive * batch`` candidates and ``uniforms``
    ``(chunk, batch // 2)`` the draws that pick the refinement half;
    ``rba_w`` holds RBA's per-point weights, ``causal_eps`` the causal
    temperature (0-d, so that a new value needs no new graph), ``wts`` the
    balanced term weights and ``probes`` the NTK probes of the term blocks
    larger than ``_NTK_PROBES``, drawn before each rebalance.  Nothing is
    drawn at random inside a step.

    :meth:`run` takes steps: eagerly on the CPU, or when ``capture`` is off;
    on the card the configuration's first step runs eagerly on a side
    stream (the warm-up, a real step), the next one captures the closure as
    a CUDA graph, and every step from then on replays it.  A rebalance step
    of loss balancing (``step(rebalance=True)``) is a kind of its own, with
    ``rebalance_eager``, ``rebalance_replays`` and ``rebalance_graph``,
    which the host picks by the fit-local step.  Host values the step reads
    are staged on the device by the warm-up
    (:func:`~pydens_tpu_torch.ops.tokens.staging`).  A capture that fails
    raises with its first error and the site; nothing falls back.

    With :class:`~pydens_tpu_torch.utils.optimizers.LMConfig` a step is one
    Levenberg-Marquardt update of the residual vector (``loss_fn.resvec``),
    its conjugate-gradient loop a fixed trip count in the graph; ``live``
    sums the live CG iterations on the device.

    An ensemble's ``theta`` is ``(K, P)`` and ``loss_fn`` gives one loss a
    member: a step descends their sum, so each member gets exactly its own
    gradient, on the one shared batch, and the losses buffer, the guard and
    ``until_loss`` read their mean (``pydens_tpu/solver.py:1403-1410``)."""

    def __init__(self, loss_fn, opt, mask, theta, chunk, batch_size,
                 resample, guard, capture, options=_Collocation(),
                 generator=None):
        dev, dtype = theta.device, theta.dtype
        total = loss_fn.total
        self.loss_fn = loss_fn
        self.opt = opt
        self.mask = mask
        self.options = options
        self.generator = generator
        self.batch_size = batch_size
        self.theta = theta.detach().clone().requires_grad_(True)
        self.state = opt.init(self.theta.detach())
        self.armed = (torch.ones((), dtype=torch.bool, device=dev)
                      if guard else None)
        self.tol = (torch.full((), -np.inf, dtype=dtype, device=dev)
                    if guard else None)
        self.index = torch.zeros((), dtype=torch.int64, device=dev)
        # Adaptive sampling draws new candidates every step.
        self.resample = resample or bool(options.adaptive)
        self.points = torch.zeros(
            (chunk if self.resample else 1,
             (options.adaptive or 1) * batch_size, total),
            dtype=dtype, device=dev)
        self.uniforms = (torch.zeros((chunk, batch_size // 2), dtype=dtype,
                                     device=dev)
                         if options.adaptive else None)
        self.causal_eps = (torch.zeros((), dtype=dtype, device=dev)
                           if options.causal else None)
        self.rba_w = (torch.ones((batch_size,), dtype=dtype, device=dev)
                      if options.rba else None)
        self.wts = (torch.tensor([w for _, w in loss_fn.term_order],
                                 dtype=dtype, device=dev)
                    if options.balance_every else None)
        self.probes = None
        self.losses = torch.zeros((chunk,), dtype=dtype, device=dev)
        self.live = torch.zeros((), dtype=torch.int64, device=dev)
        self.capture = capture
        self.graph = None
        self.constants = {}
        self.eager_steps = 0     # steps run eagerly (the warm-up, or all)
        self.replays = 0         # steps run as replays of the graph
        self.rebalance_graph = None
        self.rebalance_eager = 0
        self.rebalance_replays = 0

    def _points_row(self):
        if self.resample:
            return self.points.index_select(0, self.index)[0]
        return self.points[0]

    def _batch(self):
        """This step's points and their weights (None: all 1): the points
        row, or with ``adaptive`` the hybrid batch from the row's
        candidates, a uniform half (the last ``batch - batch // 2``) and a
        half picked from the others in proportion to their |residual|
        (``pydens_tpu/solver.py:1215-1262``).  The pool's residual is a
        forward pass only."""
        pts = self._points_row()
        if not self.options.adaptive:
            return pts, None
        n_uni = self.batch_size - self.batch_size // 2
        m_pool = pts.shape[0] - n_uni
        r = self.loss_fn.point_residual(self.theta.detach(),
                                        pts[:m_pool])[:, 0].detach()
        idx, w_sel = _adaptive_pick(
            r, self.uniforms.index_select(0, self.index)[0], m_pool)
        return (torch.cat([pts[m_pool:], pts[idx]]),
                torch.cat([w_sel.new_ones((n_uni,)), w_sel]))

    def _masked(self, g):
        g = torch.zeros_like(self.theta) if g is None else g
        return g if self.mask is None else g * self.mask

    def _grad_norms(self, terms):
        """Each term's mean |gradient| (``rebalance``,
        ``pydens_tpu/solver.py:1120-1139``; an ensemble's over its whole
        ``(K, P)`` gradient): a pullback per term through the step's one
        forward pass."""
        return torch.stack([torch.mean(torch.abs(self._masked(
            torch.autograd.grad(_total(t), self.theta, retain_graph=True,
                                allow_unused=True)[0]))) for t in terms])

    def _draw_probes(self):
        for p in (self.probes or {}).values():
            p.copy_(torch.randint(0, 2, p.shape, generator=self.generator,
                                  device=p.device).to(p.dtype) * 2 - 1)

    def _ntk_traces(self, blocks):
        """Each term's NTK trace ``|d block / d theta|_F^2`` without the
        frozen coordinates (``rebalance_ntk``,
        ``pydens_tpu/solver.py:1141-1204``): the mean of ``|J^T u|^2`` over
        the Rademacher ``probes``, or the sum over the basis for a block of
        at most ``_NTK_PROBES`` entries (exact); a pullback each.  The
        probes are made (and drawn) when the first rebalance step, which
        runs eagerly, meets the blocks.  An ensemble's blocks are ``(K,
        size)``: each member has its own probes, one pullback serves all
        (their Jacobians are independent), and the traces are the members'
        mean (``pydens_tpu/solver.py:1198-1200``)."""
        if self.probes is None:
            self.probes = {j: b.new_empty((_NTK_PROBES,) + b.shape)
                           for j, b in enumerate(blocks)
                           if b.shape[-1] > _NTK_PROBES}
            self._draw_probes()
        traces = []
        for j, b in enumerate(blocks):
            cts = self.probes.get(j)
            if cts is None:
                cts = torch.eye(b.shape[-1], dtype=b.dtype, device=b.device)
            acc = 0.0
            for ct in cts:
                g = self._masked(torch.autograd.grad(
                    b, self.theta, ct.expand_as(b), retain_graph=True,
                    allow_unused=True)[0])
                acc = acc + torch.sum(g * g)
            acc = acc / _NTK_PROBES if j in self.probes else acc
            traces.append(acc if b.dim() == 1 else acc / b.shape[0])
        return torch.stack(traces)

    def _loss(self, rebalance=False):
        """The step's loss at ``theta``, after the per-step updates of the
        options: RBA's weights from this forward pass's residual, and on a
        rebalance step the term weights (left as they are once the guard
        has tripped)."""
        pts, weight = self._batch()
        residuals, values, leaf = self.loss_fn.evaluate(self.theta, pts)
        if self.rba_w is not None:
            eta, gamma = self.options.rba
            r = self.loss_fn.member_mean(
                _abs_residual(residuals, leaf))[:, 0].detach()
            self.rba_w.copy_(_rba_update(self.rba_w, r, eta, gamma))
            weight = self.rba_w * self.rba_w
        terms = self.loss_fn.terms(residuals, values, leaf, pts, weight,
                                   self.causal_eps)
        if rebalance:
            stat = (self._ntk_traces(self.loss_fn.blocks(residuals, values))
                    if self.options.balance_mode == "ntk"
                    else self._grad_norms(terms))
            new = _anchored_ema(stat, self.wts,
                                self.loss_fn.term_order[0][1])
            if self.armed is not None:
                new = torch.where(self.armed, new, self.wts)
            self.wts.copy_(new)
        return self.loss_fn.combine(self.theta, terms, self.wts)

    def _record(self, loss):
        """The guard's flag, the loss slot and the index after a step whose
        loss at the start was ``loss``."""
        if self.armed is not None:
            # tol < loss < inf: finite and above tol, in fewer device ops
            # than isfinite's four.
            self.armed.logical_and_((loss > self.tol) & (loss < np.inf))
        self.losses.index_copy_(0, self.index, loss)
        self.index.add_(1)

    def step(self, rebalance=False):
        """One training step; reads and writes only the buffers above.  The
        update of the iteration that trips the guard is kept; every later
        one is a no-op."""
        if isinstance(self.opt, LMConfig):
            pts = self._points_row()
            loss, live = self.opt.update(
                self.theta, lambda th: self.loss_fn.resvec(th, pts),
                self.state, mask=self.mask, gate=self.armed)
            self.live.add_(live)
        else:
            loss = self._loss(rebalance)
            grad, = torch.autograd.grad(_total(loss), self.theta)
            if self.mask is not None:
                grad = grad * self.mask
            loss = loss.detach()
            self.opt.update(self.theta, grad, self.state, gate=self.armed)
        self._record(_mean(loss))

    def run(self, n, start=0):
        """Take ``n`` steps from the device index 0, the first being the
        fit's step ``start`` (the rebalance window counts from the fit's
        first step).  If one raises (a capture that fails), ``theta``, the
        state and the weights are put back as they were before the first,
        so the fit commits the last whole chunk."""
        buffers = [self.theta, *self.state.values()] + [
            t for t in (self.wts, self.rba_w) if t is not None]
        saved = [t.detach().clone() for t in buffers]
        self.index.zero_()
        try:
            for i in range(n):
                if self.options.rebalances(start + i):
                    self._draw_probes()
                    self._one_step(rebalance=True)
                else:
                    self._one_step()
        except BaseException:
            with torch.no_grad():
                for dst, src in zip(buffers, saved):
                    dst.copy_(src)
            raise

    def _one_step(self, rebalance=False):
        if rebalance:
            (self.rebalance_eager, self.rebalance_replays,
             self.rebalance_graph) = self._take(
                lambda: self.step(rebalance=True), self.rebalance_eager,
                self.rebalance_replays, self.rebalance_graph)
        else:
            self.eager_steps, self.replays, self.graph = self._take(
                self.step, self.eager_steps, self.replays, self.graph)

    def _take(self, fn, eager, replays, graph):
        """One step of ``fn``, its kind's tally being ``(eager, replays,
        graph)``: run eagerly, as the warm-up, or as a replay of the kind's
        graph (captured on first need).  Returns the new tally."""
        if not self.capture:
            fn()
            return eager + 1, replays, graph
        if not eager:
            self._warm_up(fn)
            return 1, replays, graph
        if graph is None:
            graph = self._capture(fn)
        graph.replay()
        return eager, replays + 1, graph

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
    loss and its gradient on the step's points (``step_points``, with
    ``adaptive`` their weights ``step_weight``); ``live`` sums the trials on
    the device.

    ``masked`` puts every trial a step may take (``max_linesearch_steps``,
    each a no-op once the search has ended) into the one step graph, which
    then needs no host read (the design timed against this one)."""

    def __init__(self, *args, masked=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.ls = self.opt.scratch(self.theta.detach())
        theta = self.theta.detach()
        self.step_points = theta.new_zeros((self.batch_size,
                                            self.points.shape[2]))
        self.step_weight = (theta.new_zeros((self.batch_size,))
                            if self.options.adaptive else None)
        self.masked = masked
        self.trial_graph = None
        self.eager_trials = 0    # trials after a step's first, run eagerly
        self.trial_replays = 0   # and as replays of the trial graph

    def _value_and_grad(self, point):
        point = point.detach().requires_grad_(True)
        loss = self.loss_fn(point, self.step_points, self.step_weight,
                            causal_eps=self.causal_eps)
        grad, = torch.autograd.grad(_total(loss), point)
        return loss.detach(), grad

    def trial(self):
        was = self.opt.trial(self.theta, self.state, self.ls,
                             self._value_and_grad)
        self.live.add_(_any(was).to(torch.int64))

    def step(self):
        pts, weight = self._batch()
        with torch.no_grad():
            self.step_points.copy_(pts)
            if weight is not None:
                self.step_weight.copy_(weight)
        loss = self.loss_fn(self.theta, self.step_points, self.step_weight,
                            causal_eps=self.causal_eps)
        grad, = torch.autograd.grad(_total(loss), self.theta)
        if self.mask is not None:
            grad = grad * self.mask
        loss = loss.detach()
        self.opt.begin(self.theta.detach(), loss, grad, self.state, self.ls,
                       gate=self.armed)
        trials = (self.opt.linesearch.max_linesearch_steps if self.masked
                  else 1)
        for _ in range(trials):
            self.trial()
        self._record(_mean(loss))

    def _eager_step(self):
        self.step()
        while bool(_any(self.ls["active"])):
            self.trial()
            self.eager_trials += 1

    def _one_step(self, rebalance=False):
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
        # The one host read of a trial, for every member at once.
        while bool(_any(self.ls["active"])):
            if self.trial_graph is None:
                self.trial_graph = self._capture(self.trial)
            self.trial_graph.replay()
            self.trial_replays += 1


def _total(loss):
    """What a step descends: a loss, or the sum of an ensemble's member
    losses."""
    return loss if loss.dim() == 0 else loss.sum()


def _mean(loss):
    """What the history records: a loss, or an ensemble's member mean."""
    return loss if loss.dim() == 0 else loss.mean()


def _any(flag):
    return flag if flag.dim() == 0 else flag.any()


def _abs_residual(residuals, leaf):
    """Per-point |residual| ``(batch, 1)``, summed over a system's
    residuals and their components."""
    acc = torch.zeros_like(leaf)
    for res in residuals:
        acc = acc + torch.sum(torch.abs(res), dim=1, keepdim=True)
    return acc


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
        kwargs (``layout``, ``features``/``units``, ``activation``,
        ``periodic``, ``fourier_features``, ``arch``, ``branches``,
        ``adaptive_activation``, ``initial_condition_t``,
        ``periodic_ic_decay``, ...).
    constraints : callable or sequence of callables, optional
        ``constraint(f, *coords)``, where ``f`` evaluates the model at any
        points (``f(np.array([0.5]))``; ``D`` works on ``f(x, ...)`` of
        coordinate symbols; ``f.grad(*pts, wrt=k or (k, l, ...))`` is a
        derivative at fixed points).  Trained through the ``constraint_k``
        loss terms as ``criterion(c, 0)``.
    seed : int
        Seed of the parameter-init generator (CPU) and of the sampling
        generator (on ``device``).
    n_models : int
        Train an ensemble of ``n_models`` independently initialized
        networks at once, on one shared batch a step: every parameter leaf
        carries a leading ``(n_models,)`` axis, V-token variables included
        (one per member), and the Taylor and MLP kernels take the members
        on their grid's second axis, one launch for all.  ``predict``
        returns the member mean, :meth:`predict_std` the pointwise standard
        deviation, :meth:`predict_all` every member.
    device : str or torch.device, optional
        Where parameters live and training runs; default the CUDA card
        (an error without one: pass ``device="cpu"`` for the CPU).
    formulation : str
        ``'residual'`` (default): the equation returns a strong-form
        residual, trained to zero in mean square.  ``'variational'``: the
        equation returns a Deep Ritz energy density whose mean is minimized
        directly, e.g. ``0.5 * D(f, x)**2 - source * f`` for ``-u'' =
        source``; incompatible with ``fit(adaptive=, causal=, rba=)``,
        NTK balancing and LM.
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
        # pydens_tpu's default is taken; a mesh is a feature of a later
        # slice (ROADMAP.md Queue 1 item).
        if mesh is not None:
            raise NotImplementedError(
                f"Solver(mesh={mesh!r}) is not ported to pydens_tpu_torch "
                "yet (ROADMAP.md, Queue 1 item 15)")
        if (isinstance(n_models, bool)
                or not isinstance(n_models, (int, np.integer))
                or n_models < 1):
            raise ValueError(
                f"n_models must be an int >= 1, got {n_models!r}")
        self.n_models = int(n_models)
        if formulation not in ("residual", "variational"):
            raise ValueError(
                f"formulation must be 'residual' or 'variational', got "
                f"{formulation!r}")
        # 'variational' is Deep Ritz: the equation returns an energy
        # density whose mean is minimized.
        self.formulation = formulation
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
        self.last_balanced_weights = None   # set by load() from a snapshot
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
        self._residual_fn = None

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
        if self.n_models > 1:
            # The members, drawn from the seed after the discovery run
            # (which ran one model), as reset(seed) draws them.
            self.model.make_ensemble(self.n_models)
            self._init_generator.manual_seed(seed)
            self.model.reset_parameters(self._init_generator)

    @property
    def params(self):
        """The full parameter tree (net + log_scale + V variables)."""
        return self.model.params

    def reset(self, seed=None):
        """Re-initialize the parameters and V variables as ``__init__``
        does (an ensemble's members anew from the generator), and clear
        the loss history, the fit history, the optimizer and its state and
        the step counter, keeping the cached fit steps
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

    def _spec(self):
        """The flat spec of the model's parameters (``(K, P)`` for an
        ensemble)."""
        return _FlatSpec(self.model.params, self.n_models)

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
        ``wrt=(0, 0)`` for the second derivative.  In an ensemble fixed
        points are evaluated by every member (member-major rows, one
        block a member); coordinate expressions already hold a row block
        a member."""
        model = self.model
        K = self.n_models

        def members(xs_c, pts):
            if K == 1 or any(isinstance(p, Expr) for p in pts):
                return xs_c
            return xs_c.repeat(K, 1)

        def fwd(*pts):
            if any(isinstance(p, Expr) for p in pts):
                def fn():
                    vals = [p.value if isinstance(p, Expr) else p
                            for p in pts]
                    return model.apply(params, self._concat_points(vals))
                return Expr(fn, ctx)
            return model.apply(params, members(
                self._concat_points(list(pts)), pts))

        def fwd_grad(*pts, wrt=0):
            xs_c = members(self._concat_points(
                [p.value if isinstance(p, Expr) else p for p in pts]), pts)
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
    def _build_loss_fn(self, loss_terms, criterion, use_plan=False,
                       causal=None):
        """The total loss as a function of the flat parameter vector and a
        ``(batch, total)`` batch of points: the equation term first, then
        each requested constraint as ``criterion(c, zeros((1,)))``, each
        times its weight (``term_order``: ``(name, weight)`` pairs).

        ``loss_fn(theta, pts, point_weight=None, term_weights=None,
        causal_eps=None)``: ``point_weight`` ``(batch,)`` scales the
        equation residual by its square root (adaptive sampling, RBA);
        ``term_weights`` ``(n_terms,)`` replaces the static weights (loss
        balancing); ``causal_eps`` (a float or 0-d tensor) is the causal
        temperature when ``causal`` = ``(time column, lo, hi)`` is given.
        Under ``formulation='variational'`` the equation term is the plain
        mean of the energy density.  The same loss in parts, for steps
        that read the residuals in between: ``loss_fn.evaluate`` (the
        residuals and constraint values), ``loss_fn.terms`` (the
        unweighted terms from them), ``loss_fn.combine`` (their weighted
        sum) and ``loss_fn.blocks`` (``term_blocks`` from them).
        ``loss_fn.point_residual(theta, pts)`` is the per-point
        |residual| ``(batch, 1)``, summed over a system's residuals;
        ``loss_fn.term_blocks(theta, pts)`` the per-term residual blocks,
        each scaled by ``1/sqrt(size)`` (a system's residuals form one
        block), whose squared sums are the unweighted MSE terms.

        ``use_plan=True`` computes every pure field tap the equation takes
        in ONE Taylor traversal (``Model.full_taps``) and the equation reads
        them from the table; otherwise ``D`` takes nested gradients on
        per-coordinate leaves that require grad.  Both are exact.  With
        constraint terms the leaves require grad on the plan too, for ``D``
        inside a constraint.
        """
        eq_weight = dict(loss_terms).get("equation")
        nums = _constraint_terms(loss_terms, len(self.constraints))
        term_order = ((["equation"] if eq_weight is not None else [])
                      + [f"constraint_{num}" for num, _ in nums])
        weights = (([eq_weight] if eq_weight is not None else [])
                   + [w for _, w in nums])
        constraints = self.constraints
        model = self.model
        equation = self.equation
        total = model.total
        variational = self.formulation == "variational"
        K = self.n_models
        spec = self._spec()
        plan_derivs = self._plan_derivs if use_plan else None

        def term_values(theta, pts, with_equation=eq_weight is not None,
                        with_constraints=True):
            """The equation's residuals (None without ``with_equation``)
            and the requested constraints' values at ``theta``; an
            ensemble's ``(K * N, ...)`` member-major rows, the ``N`` points
            repeated for each member, each member's derivative leaves its
            own rows."""
            params = spec.unflatten(theta)
            with_constraints = with_constraints and bool(nums)
            rows = pts if K == 1 else pts.repeat(K, 1)
            if plan_derivs is None or with_constraints:
                leaves = [rows[:, k:k + 1].detach().requires_grad_(True)
                          for k in range(total)]
            else:
                leaves = [rows[:, k:k + 1] for k in range(total)]
            residuals, values = None, []
            with variable_scope("read", params["variables"]), \
                    member_scope(K, pts.shape[0]):
                table = (model.full_taps(params, pts, plan_derivs)
                         if plan_derivs is not None else None)
                ctx = EvalContext(leaves, table=table)
                f = Expr(lambda: model.apply_leaves(params, ctx.leaves), ctx,
                         deriv=())
                coords = [Expr(_leaf_fn(ctx, k), ctx, leaf_index=k)
                          for k in range(total)]
                if with_equation:
                    residuals = [as_array(res) for res in
                                 _as_residual_list(equation(f, *coords))]
                if with_constraints:
                    fwd = self._make_forward(params, ctx)
                    values = [as_array(constraints[num](fwd, *coords))
                              for num, _ in nums]
            return residuals, values, leaves[0]

        def causal_term(residuals, pts, eps, K=K):
            """The 32-bin pointwise causal weighting of the squared
            residual (``pydens_tpu/solver.py:749-801``): bin i's mean L_i,
            weights ``exp(-eps * sum_{j<i} L_j / sum_j L_j)`` without
            gradient, self-normalized, so eps = 0 is the plain MSE.  The bin
            sums are one-hot reductions, in a fixed order (no atomics)."""
            if K > 1:   # each member's own weights
                n = pts.shape[0]
                return torch.stack([causal_term(
                    [r[k * n:(k + 1) * n] for r in residuals], pts, eps, 1)
                    for k in range(K)])
            t_idx, t_lo, t_hi = causal
            n_bins = 32
            sq = 0.0
            for res in residuals:
                sq = sq + torch.mean(res * res, dim=1)
            tcol = ((pts[:, t_idx] - t_lo) / (t_hi - t_lo)).detach()
            bins = (tcol * n_bins).to(torch.int64).clamp(0, n_bins - 1)
            onehot = (bins[:, None] == torch.arange(
                n_bins, device=pts.device)).to(sq.dtype)
            sums = (onehot * sq.detach()[:, None]).sum(0)
            L = sums / onehot.sum(0).clamp(min=1.0)
            earlier = torch.ones((n_bins, n_bins), dtype=sq.dtype,
                                 device=pts.device).tril(-1)
            cum = (earlier * L).sum(1)
            cum = cum / (cum[-1] + L[-1]).clamp(min=1e-30)
            w_pt = torch.exp(-eps * cum)[bins]
            return torch.sum(w_pt * sq) / w_pt.sum().clamp(min=1e-30)

        def terms(residuals, values, leaf, pts, point_weight=None,
                  causal_eps=None):
            """The unweighted terms, in ``term_order``."""
            out = []
            if residuals is not None and causal is not None:
                out.append(causal_term(residuals, pts, causal_eps))
            elif residuals is not None and variational:
                out.append(sum(member_mean_of(res) for res in residuals))
            elif residuals is not None:
                acc = 0.0
                if point_weight is not None and K > 1:
                    point_weight = point_weight.repeat(K)
                for res in residuals:
                    if point_weight is not None:
                        res = res * torch.sqrt(point_weight)[:, None]
                    acc = acc + member_losses(criterion, res,
                                              torch.zeros_like(leaf), K)
                out.append(acc)
            if values:
                zero = leaf.new_zeros((1,))
                out += [member_losses(criterion, c, zero, K) for c in values]
            return out

        def member_mean_of(res):
            """The mean over each member's rows."""
            return torch.mean(res) if K == 1 else res.reshape(K, -1).mean(1)

        def combine(theta, parts, term_weights=None):
            if not parts:   # only unknown names: a zero loss
                return theta[..., :0].sum(-1)
            loss = theta.new_zeros(theta.shape[:-1])
            for j, t in enumerate(parts):
                w = weights[j] if term_weights is None else term_weights[j]
                loss = loss + w * t
            return loss

        def loss_fn(theta, pts, point_weight=None, term_weights=None,
                    causal_eps=None):
            residuals, values, leaf = term_values(theta, pts)
            return combine(theta, terms(residuals, values, leaf, pts,
                                        point_weight, causal_eps),
                           term_weights)

        def member_mean(t):
            """An ensemble's member-major ``(K * N, c)`` rows averaged over
            the members, ``(N, c)``: what the adaptive pool and RBA rank
            (``pydens_tpu/solver.py:1234-1236, 1297-1299``)."""
            return t if K == 1 else t.reshape(K, -1, t.shape[-1]).mean(0)

        def point_residual(theta, pts):
            residuals, _, leaf = term_values(theta, pts, with_equation=True,
                                             with_constraints=False)
            return member_mean(_abs_residual(residuals, leaf))

        lead = () if K == 1 else (K,)

        def block(t):
            """A residual or constraint value as one member's flat block
            scaled by ``1/sqrt(size)``, ``(K, size)`` for an ensemble."""
            return t.reshape(lead + (-1,)) * (K / t.numel()) ** 0.5

        def blocks(residuals, values):
            out = []
            if residuals is not None:
                out.append(torch.cat([block(r) for r in residuals], dim=-1))
            out += [block(c) for c in values]
            return tuple(out)

        def term_blocks(theta, pts):
            residuals, values, _ = term_values(theta, pts)
            return blocks(residuals, values)

        def resvec(theta, pts):
            """The stacked residual vector ``r`` with ``loss_fn == r . r``
            for the MSE criterion: the term blocks, each scaled by
            ``sqrt(weight)`` (``resvec_fn`` of ``pydens_tpu/solver.py``),
            for Levenberg-Marquardt."""
            out = [b * w ** 0.5 for b, w in zip(
                blocks(*term_values(theta, pts)[:2]), weights)]
            if not out:
                return theta.new_zeros(lead + (1,))
            return torch.cat(out, dim=-1)

        loss_fn.spec = spec
        loss_fn.total = total
        loss_fn.term_order = tuple(zip(term_order, weights))
        loss_fn.evaluate = term_values
        loss_fn.terms = terms
        loss_fn.combine = combine
        loss_fn.blocks = blocks
        loss_fn.point_residual = point_residual
        loss_fn.member_mean = member_mean
        loss_fn.term_blocks = term_blocks
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
            adaptive=None, fast_taps="auto", callback=None,
            loss_balancing=None, checkpoint_path=None, checkpoint_every=None,
            stop_on_nan=True, causal=None, causal_axis=None, rba=None,
            until_loss=None, **kwargs):
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

        The collocation and objective options of ``pydens_tpu``'s ``fit``,
        each drawn outside the step and so under its CUDA graph too:

        * ``adaptive=r`` (int >= 2): each step draws ``r * batch_size``
          candidates and trains on a hybrid batch, half uniform and half
          picked in proportion to the |equation residual| of the rest, with
          importance weights ``1/(M p)`` that keep the MSE unbiased (a
          device sampler, the equation term and the MSE criterion).
        * ``rba=True`` / ``eta`` / ``(eta, gamma)`` (defaults 0.01, 0.999):
          residual-based attention, per-point weights ``w <- gamma w + eta
          |r| / max |r|`` on the fixed batch (``resample=False``), reset at
          each fit, loss ``mean((w r)^2)``.
        * ``causal=eps`` (>= 0): the batch's squared residual in 32 time
          bins, bin i weighted by ``exp(-eps * cumulative earlier-bin
          residual / total)`` and self-normalized; ``eps = 0`` is the plain
          MSE, and a new eps reuses the cached step.  The time column is
          the last variable (an ``initial_condition`` is needed) or
          ``causal_axis=k``.
        * ``loss_balancing=True`` / interval / ``'grad'`` / ``'ntk'`` /
          ``(mode, interval)`` (default interval 100): in the fit's first
          10 intervals, one step each rebalances the term weights towards
          the equation term's per-term statistic (mean |gradient|, or the
          NTK trace from 4 Rademacher probes a term), clipped to two
          decades, EMA-smoothed; they start from ``loss_terms`` and land in
          ``history[-1]['balanced_weights']``.

        ``pydens_tpu``'s exclusivity rules hold, with its ``ValueError``
        messages.
        """
        fit_t0 = time.perf_counter()
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
            self._check_lm(criterion_key, adaptive, causal, rba,
                           loss_balancing)
        options, causal_eps = self._collocation(
            loss_terms, criterion_key, sampler, resample, adaptive, rba,
            causal, causal_axis, loss_balancing)
        batch_size = int(batch_size)
        chunk = max(1, min(niters, int(chunk_size)))
        step = self._fit_step(loss_terms, criterion_fn, use_plan, batch_size,
                              chunk, bool(resample), bool(stop_on_nan),
                              options)
        if step.causal_eps is not None:
            step.causal_eps.fill_(causal_eps)
        if step.wts is not None:    # each fit starts from loss_terms
            step.wts.copy_(torch.as_tensor([w for _, w in
                                            step.loss_fn.term_order]))
        if step.rba_w is not None:  # and from no attention
            step.rba_w.fill_(1.0)
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
        if not step.resample:
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

        def balanced_weights():
            return None if step.wts is None else step.wts.tolist()

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
                        step_counter=self._step_counter + iters_run,
                        balanced_weights=balanced_weights())

        try:
            with profiler:
                for start in bounds:
                    n = min(chunk, niters - start)
                    if step.resample:
                        step.points[:n].copy_(self._sample(
                            sampler, n, step.points.shape[1]))
                    if step.uniforms is not None:
                        step.uniforms[:n].copy_(torch.rand(
                            step.uniforms[:n].shape,
                            generator=self._generator, device=self.device,
                            dtype=self.model.dtype))
                    step.run(n, start)
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
        if step.wts is not None:
            self.history[-1]["balanced_weights"] = balanced_weights()
        if nan_stop is not None:
            self.history[-1]["stopped_on_nan"] = int(nan_stop)
        if converged_at is not None:
            self.history[-1]["converged_at"] = int(converged_at)
        return self

    def _check_lm(self, criterion_key, adaptive, causal, rba,
                  loss_balancing):
        """Levenberg-Marquardt's conditions (``pydens_tpu``'s ``fit``,
        ``solver.py:1739-1766``): the plain least-squares MSE objective, so
        that ``loss == |r|^2``."""
        if self.formulation == "variational":
            raise ValueError(
                "optimizer='LM' (Gauss-Newton) minimizes a sum of "
                "squared residuals; a variational (Deep Ritz) energy "
                "is not a least-squares objective — use "
                "formulation='residual'")
        if (isinstance(criterion_key, str)
                and criterion_key not in ("mseloss", "mse")):
            raise ValueError(
                "optimizer='LM' (Gauss-Newton) is defined for the MSE "
                "criterion (loss == ||residual||^2)")
        if adaptive is not None or causal is not None or (
                rba is not None and rba is not False):
            raise ValueError(
                "optimizer='LM' (Gauss-Newton) targets the plain MSE "
                "residual; per-point/causal reweighting (adaptive/"
                "causal/rba) changes the objective every iteration — "
                "run those during the Adam phase, then polish with LM")
        if loss_balancing:
            raise ValueError(
                "optimizer='LM' (Gauss-Newton) already solves the "
                "coupled normal equations across all loss terms; "
                "grad-norm loss_balancing does not apply — bake fixed "
                "weights into loss_terms instead")

    def _collocation(self, loss_terms, criterion_key, sampler, resample,
                     adaptive, rba, causal, causal_axis, loss_balancing):
        """The fit's :class:`_Collocation` and causal temperature from its
        arguments, with ``pydens_tpu``'s checks and messages
        (``solver.py:1767-1990``)."""
        mse = (isinstance(criterion_key, str)
               and criterion_key in ("mseloss", "mse"))
        variational = self.formulation == "variational"
        linesearch = isinstance(self._opt, LBFGS)
        has_equation = "equation" in dict(loss_terms)
        if adaptive is not None:
            adaptive = int(adaptive)
            if variational:
                raise ValueError(
                    "adaptive sampling ranks points by the strong-form "
                    "residual, which a variational (Deep Ritz) solver does "
                    "not compute — use formulation='residual'")
            if adaptive < 2:
                raise ValueError("adaptive must be an int >= 2 (candidate "
                                 "oversampling factor)")
            if sampler is not None and not getattr(sampler,
                                                   "supports_device", False):
                raise ValueError(
                    "adaptive sampling runs device-side; the supplied "
                    "sampler has no sample_device path")
            if not has_equation:
                raise ValueError("adaptive sampling ranks points by the "
                                 "equation residual; include 'equation' in "
                                 "loss_terms")
            if isinstance(criterion_key, str) and not mse:
                raise ValueError(
                    "adaptive importance weights scale the residual by "
                    "sqrt(w), which keeps only the MSE criterion unbiased; "
                    "use criterion='MSELoss' (or a custom callable you "
                    "know composes with sqrt-weighting)")

        rba_cfg = None
        if rba is not None and rba is not False:
            if rba is True:
                eta, gamma = 0.01, 0.999
            elif isinstance(rba, (tuple, list)) and len(rba) == 2:
                eta, gamma = float(rba[0]), float(rba[1])
            elif isinstance(rba, (int, float)):
                eta, gamma = float(rba), 0.999
            else:
                raise ValueError(
                    f"rba={rba!r} not understood; use True, eta, or "
                    "(eta, gamma)")
            if not (eta > 0 and 0 <= gamma < 1):
                raise ValueError("rba needs eta > 0 and 0 <= gamma < 1")
            if resample:
                raise ValueError(
                    "rba weights track FIXED collocation points across "
                    "iterations; pass resample=False (one batch for the "
                    "whole fit)")
            if adaptive is not None:
                raise ValueError("rba and adaptive are both per-point "
                                 "residual reweighting schemes — use one")
            if causal is not None:
                raise ValueError(
                    "rba point weights are not applied inside the causal "
                    "bin weighting — use one of the two")
            if variational:
                raise ValueError(
                    "rba weights the strong-form residual; it is undefined "
                    "for a variational (Deep Ritz) energy")
            if not has_equation:
                raise ValueError("rba weights the equation residual; "
                                 "include 'equation' in loss_terms")
            if isinstance(criterion_key, str) and not mse:
                raise ValueError("rba is defined for the MSE criterion "
                                 "(loss mean((w*r)^2))")
            if linesearch:
                raise ValueError(
                    "rba changes the objective every iteration; linesearch "
                    "optimizers (LBFGS) assume a fixed one — run rba during "
                    "the Adam phase, then polish without it")
            rba_cfg = (eta, gamma)

        causal_eps = 0.0
        if causal is None and causal_axis is not None:
            raise ValueError(
                "causal_axis names the time column FOR causal training — "
                "it does nothing on its own; pass fit(causal=eps, "
                "causal_axis=k)")
        if causal is not None:
            causal_eps = float(causal)
            if variational:
                raise ValueError(
                    "causal training weights strong-form residuals over "
                    "time; it is undefined for a variational (Deep Ritz) "
                    "energy — use formulation='residual'")
            if causal_eps < 0:
                raise ValueError("causal must be a float >= 0 (the "
                                 "causal-weighting temperature eps)")
            if self.model.initial_condition is None and causal_axis is None:
                raise ValueError(
                    "causal training needs a time axis — construct the "
                    "Solver with an initial_condition (time is the last "
                    "variable column, as in the ansatz), or pass "
                    "fit(causal_axis=k) to name the time column explicitly "
                    "(penalty-IC workflows, e.g. a non-periodic-compatible "
                    "initial state bound by a constraint)")
            if not has_equation:
                raise ValueError("causal training weights the equation "
                                 "residual; include 'equation' in "
                                 "loss_terms")
            if not mse:
                raise ValueError("causal training is defined for the MSE "
                                 "criterion")
            if adaptive is not None:
                raise ValueError("causal and adaptive sampling both "
                                 "reweight the equation residual — use one")
            t_axis = (self.model.ndims - 1 if causal_axis is None
                      else int(causal_axis))
            if not 0 <= t_axis < self.model.ndims:
                raise ValueError(
                    f"causal_axis={causal_axis} out of range for "
                    f"{self.model.ndims} variable columns")
            t_lo, t_hi = self.model.domain[t_axis]
            causal = (t_axis, float(t_lo), float(t_hi))

        balance_every, balance_mode = 0, "grad"
        if loss_balancing:
            if isinstance(loss_balancing, (tuple, list)):
                if len(loss_balancing) != 2:
                    raise ValueError(
                        "loss_balancing=(mode, interval) takes exactly two "
                        "elements, e.g. ('ntk', 100)")
                balance_mode = str(loss_balancing[0])
                balance_every = int(loss_balancing[1])
            elif isinstance(loss_balancing, str):
                balance_mode, balance_every = loss_balancing, 100
            else:
                balance_every = (100 if loss_balancing is True
                                 else int(loss_balancing))
            if balance_mode not in ("grad", "ntk"):
                raise ValueError(
                    f"loss_balancing mode {balance_mode!r} is not "
                    "recognized; use 'grad' (per-term mean gradient "
                    "magnitudes) or 'ntk' (per-term NTK traces)")
            if balance_every < 1:
                raise ValueError("loss_balancing must be True or a positive "
                                 "rebalance interval in iterations")
            if balance_mode == "ntk":
                if not mse:
                    raise ValueError(
                        "loss_balancing='ntk' estimates residual-Jacobian "
                        "traces, which represent the loss only for the MSE "
                        "criterion (custom callables included — the traces "
                        "would balance an objective the fit does not "
                        "minimize) — use the 'grad' mode otherwise")
                if variational:
                    raise ValueError(
                        "loss_balancing='ntk' needs per-term residual "
                        "vectors; a variational (Deep Ritz) energy has "
                        "none — use the 'grad' mode")
                if (adaptive is not None or causal is not None
                        or rba_cfg is not None):
                    raise ValueError(
                        "loss_balancing='ntk' traces the PLAIN residual "
                        "operator; per-point/causal reweighting (adaptive/"
                        "causal/rba) changes the objective it would "
                        "balance — use the 'grad' mode with those")
            if len(loss_terms) < 2:
                raise ValueError(
                    "loss_balancing needs at least two loss terms (an "
                    "equation plus constraints) — a single term has nothing "
                    "to balance against")
            if linesearch:
                raise ValueError(
                    "loss_balancing is not supported with linesearch "
                    "optimizers (LBFGS) — balance during the Adam phase, "
                    "then polish with fixed weights")
        return (_Collocation(adaptive, rba_cfg, causal, balance_every,
                             balance_mode), causal_eps)

    def _fit_step(self, loss_terms, criterion_fn, use_plan, batch_size,
                  chunk, resample, guard, options=_Collocation()):
        """The cached :class:`_FitStep` of a fit configuration, built on
        first use.  The optimizer instance is part of the key, and with it
        its float learning rate (baked into a captured graph) or its
        schedule; so are the collocation ``options``, but not the causal
        temperature, a buffer of the step."""
        capture = self.device.type == "cuda" and self._capture_steps
        masked = self._masked_linesearch
        key = (loss_terms, criterion_fn, self._opt, use_plan, batch_size,
               chunk, resample, guard, capture, masked, options,
               frozenset(self.model._frozen_layers),
               frozenset(self.model._frozen_variables))
        if key not in self._step_cache:
            loss_fn = self._build_loss_fn(loss_terms, criterion_fn, use_plan,
                                          options.causal)
            args = (loss_fn, self._opt, self._flat_mask(loss_fn.spec),
                    loss_fn.spec.flatten(self.model.params), chunk,
                    batch_size, resample, guard, capture)
            kwargs = dict(options=options, generator=self._generator)
            self._step_cache[key] = (
                _LinesearchFitStep(*args, masked=masked, **kwargs)
                if isinstance(self._opt, LBFGS) else _FitStep(*args, **kwargs))
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
    def residual(self, *xs):
        """The |equation residual| at the supplied points (the inputs of
        :meth:`predict`), summed over a system's components; under
        ``formulation='variational'`` the |energy density|; an ensemble's
        member mean.  Returns an ``(N, 1)`` numpy array.  On the planned
        path it runs the fused Taylor forward on the card."""
        if self._residual_fn is None:
            self._residual_fn = self._build_loss_fn(
                (("equation", 1.0),), lambda a, b: 0.0,
                use_plan=bool(self._plan_ok)).point_residual
        x = torch.as_tensor(self._normalize_inputs(xs),
                            dtype=self.model.dtype, device=self.device)
        theta = self._spec().flatten(self.model.params)
        with torch.enable_grad():
            out = self._residual_fn(theta.detach(), x)
        return out.detach().cpu().numpy()

    def _predict_raw(self, xs):
        x = torch.as_tensor(self._normalize_inputs(xs),
                            dtype=self.model.dtype, device=self.device)
        return self.model.predict_apply(self.model.params, x)

    def predict(self, *xs):
        """Evaluate the trained solution at the supplied points: arrays,
        numbers (tiled to the batch), lists, or one ``(N, ndims+nparams)``
        array of stacked coordinates.  Returns an ``(N, n_out)`` numpy
        array; the ensemble mean when ``n_models > 1``."""
        out = self._predict_raw(xs)
        if self.n_models > 1:
            out = out.mean(0)
        return out.cpu().numpy()

    def predict_all(self, *xs):
        """Every member's prediction, ``(n_models, N, n_out)`` (``(1, N,
        n_out)`` for one model), from one network pass (one MLP launch
        where the chain is in the kernel's scope)."""
        out = self._predict_raw(xs)
        if self.n_models == 1:
            out = out[None]
        return out.cpu().numpy()

    def predict_std(self, *xs):
        """The ensemble's pointwise standard deviation over its members
        (numpy's ``ddof=0``), the epistemic uncertainty of the solution,
        ``(N, n_out)``.  Requires ``n_models > 1``."""
        if self.n_models <= 1:
            raise ValueError("predict_std requires Solver(n_models > 1)")
        return self._predict_raw(xs).std(0, correction=0).cpu().numpy()
