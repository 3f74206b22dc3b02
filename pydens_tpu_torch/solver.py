"""Solver: trains a neural network to satisfy a differential equation.

Counterpart of ``pydens_tpu/solver.py`` with the same public surface for the
ported slice (``__init__`` / ``fit`` / ``predict`` / ``predict_grad`` /
``predict_grid`` / ``reshape_and_concat`` / ``.losses`` / ``.model``) and
the same reference quirks:

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
from torch.distributed.device_mesh import DeviceMesh

from . import tracing
from .models import ConvBlockModel
from .models.base import resolve_device
from .parallel.shards import Shards, mesh_axes
from .ops.tokens import (PLAN_MAX_ORDER, Expr, EvalContext,
                         _batch_diagonal_grad, as_array, as_device,
                         member_scope, staging, to_host, variable_scope)
from .utils.criteria import member_losses, resolve_criterion
from .utils.inputs import is_number, reshape_and_concat
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

    def with_members(self, n_models):
        """The same spec for ``n_models`` members (a mesh's models axis
        gives a rank its share of them)."""
        spec = _FlatSpec.__new__(_FlatSpec)
        spec.__dict__.update(self.__dict__)
        spec.lead = () if n_models == 1 else (n_models,)
        return spec

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


def _rba_update(rba_w, r, eta, gamma, shards=None):
    """Residual-based attention's EMA of the normalized |residual| ``r``
    (``pydens_tpu/solver.py:1280-1294``); on a mesh ``r`` is this rank's
    points' and the maximum is over every rank's."""
    top = torch.max(r)
    if shards is not None:
        top = shards.max(top)
    return gamma * rba_w + eta * r / (top + 1e-30)


def _member_axis(name):
    """The member axis of an optimizer state buffer of an ensemble: L-BFGS'
    memories lead with their slots, the step count has none."""
    if name == "count":
        return None
    return 1 if name.endswith("_memory") else 0


def _anchored_ema(stat, wts, anchor):
    """Inverse-statistic term weights anchored at the first term's static
    weight ``anchor``, clipped to two decades around it, the anchor pinned,
    then EMA-smoothed into ``wts`` (``_anchored_ema``,
    ``pydens_tpu/solver.py:1098-1118``)."""
    lam = (stat[0] / (stat + 1e-12) * anchor).clamp(0.01 * anchor,
                                                   100.0 * anchor)
    lam = torch.cat([lam.new_full((1,), anchor), lam[1:]])
    return 0.7 * wts + 0.3 * lam


def _sampling_seed(seed, device):
    """The sampling generator's seed for the Solver's ``seed``.  The init
    generator is a CPU generator seeded with ``seed``; a sampling generator
    on the CPU seeded alike gave the same numbers, so the first batches
    were the very draws of the initial weights (``pydens_tpu`` splits one
    key into independent init and sampling keys).  On the CPU it takes a
    child of ``numpy.random.SeedSequence(seed)`` instead.  On the card the
    sampling generator (Philox) and the init generator (Mersenne Twister)
    already give unrelated streams from one seed, so there is nothing to
    repair: it keeps ``seed``, and a card's draws stay those of earlier
    versions.  Over seeds 0-5 the examples whose asserts depend on the
    draw (09, 12, 16, 23) hold them as often with the child seed as with
    ``seed`` (``tests/example_seed_study.py``)."""
    if device.type != "cpu":
        return seed
    state = np.random.SeedSequence(seed, spawn_key=(1,)).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) | (int(state[1]) >> 1)


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
    ``until_loss`` read their mean (``pydens_tpu/solver.py:1403-1410``).

    On a mesh (``shards``, :class:`~pydens_tpu_torch.parallel.shards.
    Shards`) the points rows hold this rank's slice of each batch (``rows``
    of ``batch_size``; the whole candidate pool with ``adaptive``, whose
    residuals are gathered before the pick; the whole batch on a separable
    model's grid, which the loss shards), RBA's weights this rank's, and a
    step's loss and gradient are summed over the data ranks (its share
    each) before the update, so every rank takes the same one: one
    all-reduce a step, inside the captured graph on the card."""

    def __init__(self, loss_fn, opt, mask, theta, chunk, batch_size,
                 resample, guard, capture, options=_Collocation(),
                 generator=None, shards=None):
        dev, dtype = theta.device, theta.dtype
        total = loss_fn.total
        self.loss_fn = loss_fn
        self.opt = opt
        self.mask = mask
        self.options = options
        self.generator = generator
        self.batch_size = batch_size
        self.shards = shards
        self.rows = (shards.rows(batch_size)
                     if shards is not None and not loss_fn.on_grid
                     else batch_size)
        # Rows of one draw of the sampler, and whether the step keeps its
        # slice of them only.
        self.pool = (options.adaptive or 1) * batch_size
        self.shard_points = self.rows != batch_size and not options.adaptive
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
             self.rows if self.shard_points else self.pool, total),
            dtype=dtype, device=dev)
        self.uniforms = (torch.zeros((chunk, batch_size // 2), dtype=dtype,
                                     device=dev)
                         if options.adaptive else None)
        self.causal_eps = (torch.zeros((), dtype=dtype, device=dev)
                           if options.causal else None)
        self.rba_w = (torch.ones((self.rows,), dtype=dtype, device=dev)
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
        self.captures = 0        # graphs captured, of every kind
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
        theta = self.theta.detach()

        def residual(rows):
            return self.loss_fn.point_residual(theta, rows)[:, 0].detach()
        r = (residual(pts[:m_pool]) if self.shards is None
             else self.shards.gather_rows(residual, pts[:m_pool]))
        idx, w_sel = _adaptive_pick(
            r, self.uniforms.index_select(0, self.index)[0], m_pool)
        batch = torch.cat([pts[m_pool:], pts[idx]])
        weight = torch.cat([w_sel.new_ones((n_uni,)), w_sel])
        if self.shards is not None:
            return self.shards.shard(batch), self.shards.shard(weight)
        return batch, weight

    def _masked(self, g):
        g = torch.zeros_like(self.theta) if g is None else g
        return g if self.mask is None else g * self.mask

    def _grad_norms(self, terms):
        """Each term's mean |gradient| (``rebalance``,
        ``pydens_tpu/solver.py:1120-1139``; an ensemble's over its whole
        ``(K, P)`` gradient): a pullback per term through the step's one
        forward pass; on a mesh the gradients are summed over the ranks
        first, and an ensemble's mean is over every rank's members."""
        grads = [self._masked(torch.autograd.grad(
            _total(t), self.theta, retain_graph=True, allow_unused=True)[0])
            for t in terms]
        if self.shards is None:
            return torch.stack([torch.mean(torch.abs(g)) for g in grads])
        g, = self.shards.share_sum(torch.stack(grads))
        sums = self.shards.member_sum(torch.abs(g).reshape(len(terms),
                                                           -1).sum(1))
        return sums / (grads[0].numel() * self.shards.n_member_ranks)

    def _draw_probes(self):
        for p in (self.probes or {}).values():
            p.copy_(torch.randint(0, 2, p.shape, generator=self.generator,
                                  device=p.device).to(p.dtype) * 2 - 1)

    def _ntk_traces(self, blocks, layout=None):
        """Each term's NTK trace ``|d block / d theta|_F^2`` without the
        frozen coordinates (``rebalance_ntk``,
        ``pydens_tpu/solver.py:1141-1204``): the mean of ``|J^T u|^2`` over
        the Rademacher ``probes``, or the sum over the basis for a block of
        at most ``_NTK_PROBES`` entries (exact); a pullback each.  The
        probes are made (and drawn) when the first rebalance step, which
        runs eagerly, meets the blocks.  An ensemble's blocks are ``(K,
        size)``: each member has its own probes, one pullback serves all
        (their Jacobians are independent), and the traces are the members'
        mean (``pydens_tpu/solver.py:1198-1200``).

        On a mesh (``layout``: each block's size over every rank and the
        indices of this rank's entries in it, None for a block that every
        rank holds whole) the probes are drawn at the whole blocks' shape,
        as in one process, each rank pulls back its entries of them (a
        whole block's pullback at its share), and the pullbacks are summed
        over the ranks before they are squared."""
        shards = self.shards
        if self.probes is None:
            self.probes = {}
            for j, b in enumerate(blocks):
                size = b.shape[-1] if layout is None else layout[j][0]
                lead = (tuple(b.shape[:-1]) if shards is None
                        or shards.n_models == 1 else (shards.n_models,))
                if size > _NTK_PROBES:
                    self.probes[j] = b.new_empty((_NTK_PROBES,) + lead
                                                 + (size,))
            self._draw_probes()
        pulls = []
        for j, b in enumerate(blocks):
            cts = self.probes.get(j)
            if cts is None:
                size = b.shape[-1] if layout is None else layout[j][0]
                cts = torch.eye(size, dtype=b.dtype, device=b.device)
            elif shards is not None:
                cts = shards.local_members(cts, axis=1)
            index = None if layout is None else layout[j][1]
            pulls.append([])
            for ct in cts:
                if index is not None:
                    ct = ct.index_select(-1, index)
                g = self._masked(torch.autograd.grad(
                    b, self.theta, ct.expand_as(b), retain_graph=True,
                    allow_unused=True)[0])
                if shards is not None and index is None and shards.n_data > 1:
                    g = g * (1.0 / shards.n_data)
                pulls[-1].append(g)
        if shards is not None:
            flat = shards.sum_parts(*[g for gs in pulls for g in gs])
            pulls = [[flat.pop(0) for _ in gs] for gs in pulls]
        traces = []
        for j, (b, gs) in enumerate(zip(blocks, pulls)):
            acc = 0.0
            for g in gs:
                acc = acc + torch.sum(g * g)
            acc = acc / _NTK_PROBES if j in self.probes else acc
            if shards is not None and shards.n_models > 1:
                acc = shards.member_sum(acc) / shards.n_models
            elif b.dim() > 1:
                acc = acc / b.shape[0]
            traces.append(acc)
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
            self.rba_w.copy_(_rba_update(self.rba_w, r, eta, gamma,
                                         self.shards))
            weight = self.rba_w * self.rba_w
        terms = self.loss_fn.terms(residuals, values, leaf, pts, weight,
                                   self.causal_eps)
        if rebalance:
            stat = (self._ntk_traces(
                self.loss_fn.blocks(residuals, values),
                None if self.shards is None
                else self.loss_fn.block_layout(residuals, values))
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

    def _mean(self, loss):
        """What the history records: a loss, or the mean of an ensemble's
        member losses, over every rank's members on a models axis."""
        if self.shards is None or self.shards.model_axis is None:
            return _mean(loss)
        return self.shards.member_sum(loss.sum()) / self.shards.n_models

    def _value_and_grad(self, loss, point):
        """``loss`` (at ``point``, which requires grad) and its gradient,
        summed over the data ranks on a mesh."""
        grad, = torch.autograd.grad(_total(loss), point)
        loss = loss.detach()
        if self.shards is not None:
            loss, grad = self.shards.share_sum(loss, grad)
        return loss, grad

    def step(self, rebalance=False):
        """One training step; reads and writes only the buffers above.  The
        update of the iteration that trips the guard is kept; every later
        one is a no-op."""
        if isinstance(self.opt, LMConfig):
            pts = self._points_row()
            loss, live = self.opt.update(
                self.theta, lambda th: self.loss_fn.resvec(th, pts),
                self.state, mask=self.mask, gate=self.armed,
                reduce=None if self.shards is None
                else self.shards.sum_parts)
            self.live.add_(live)
        else:
            loss, grad = self._value_and_grad(self._loss(rebalance),
                                              self.theta)
            if self.mask is not None:
                grad = grad * self.mask
            self.opt.update(self.theta, grad, self.state, gate=self.armed)
        self._record(self._mean(loss))

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

    def tallies(self):
        """``(eager, replays, captures)``: steps run eagerly, graph
        replays of every kind (an L-BFGS step's trials too) and graphs
        captured, since the step was built."""
        return (self.eager_steps + self.rebalance_eager,
                self.replays + self.rebalance_replays, self.captures)

    def _warm_up(self, fn):
        dev = self.theta.device
        with tracing.span("pydens.fit.warmup"):
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
        # The span lies around the capture, never inside it.
        with tracing.span("pydens.fit.capture"):
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
                    f"{first}. A step must not read a device value on the "
                    "host (.item(), float(), .tolist(), a Python `if` on a "
                    "tensor), e.g. in an equation, a condition or an lr "
                    "schedule") from err
            finally:
                if collecting:
                    gc.enable()
        self.captures += 1
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
        self.step_points = theta.new_zeros((self.rows,
                                            self.points.shape[2]))
        self.step_weight = (theta.new_zeros((self.rows,))
                            if self.options.adaptive else None)
        self.masked = masked
        self.trial_graph = None
        self.eager_trials = 0    # trials after a step's first, run eagerly
        self.trial_replays = 0   # and as replays of the trial graph

    def tallies(self):
        eager, replays, captures = super().tallies()
        return eager, replays + self.trial_replays, captures

    def _trial_value_and_grad(self, point):
        point = point.detach().requires_grad_(True)
        return self._value_and_grad(self.loss_fn(
            point, self.step_points, self.step_weight,
            causal_eps=self.causal_eps), point)

    def trial(self):
        was = self.opt.trial(self.theta, self.state, self.ls,
                             self._trial_value_and_grad)
        self.live.add_(_any(was).to(torch.int64))

    def step(self):
        pts, weight = self._batch()
        with torch.no_grad():
            self.step_points.copy_(pts)
            if weight is not None:
                self.step_weight.copy_(weight)
        loss, grad = self._value_and_grad(self.loss_fn(
            self.theta, self.step_points, self.step_weight,
            causal_eps=self.causal_eps), self.theta)
        if self.mask is not None:
            grad = grad * self.mask
        self.opt.begin(self.theta.detach(), loss, grad, self.state, self.ls,
                       gate=self.armed)
        trials = (self.opt.linesearch.max_linesearch_steps if self.masked
                  else 1)
        for _ in range(trials):
            self.trial()
        self._record(self._mean(loss))

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


@contextlib.contextmanager
def _profiled(profile_dir, device):
    """A ``torch.profiler`` over the block, its chrome trace written into
    ``profile_dir`` when the block ends (nothing without a directory)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    profiler = profile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else []))
    try:
        with profiler:
            yield
    finally:
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(
            profile_dir, f"fit_{time.time_ns()}.pt.trace.json"))


class _CtxShim:
    """``Solver.ctx`` compatibility object (see the property docstring)."""

    @staticmethod
    def run(fn, *args, **kwargs):
        return fn(*args, **kwargs)


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
        ``periodic_ic_decay``, ...).  With
        :class:`~pydens_tpu_torch.SeparableModel` a fit trains on the
        tensor-product grid of each batch's columns (``batch_size`` points
        per axis, the default sampler over the declared domain).
    constraints : callable or sequence of callables, optional
        ``constraint(f, *coords)``, where ``f`` evaluates the model at any
        points (``f(np.array([0.5]))``; ``D`` works on ``f(x, ...)`` of
        coordinate symbols; ``f.grad(*pts, wrt=k or (k, l, ...))`` is a
        derivative at fixed points).  Trained through the ``constraint_k``
        loss terms as ``criterion(c, 0)``.
    seed : int
        Seed of the parameter-init generator (CPU) and of the sampling
        generator (on ``device``; on the CPU a seed derived from it, so that
        the two streams are independent).
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
    mesh : torch.distributed.device_mesh.DeviceMesh, optional
        Data parallelism over the ranks of a mesh
        (:func:`~pydens_tpu_torch.make_mesh`; one process a rank, every
        rank constructing the Solver and calling it in lockstep): each
        rank draws the same full batch and trains on its contiguous slice
        over the mesh's data axes (every axis but ``'models'``, jointly),
        the loss and gradient summed over the ranks once a step, so the
        parameters stay the same on every rank.  ``batch_size`` must divide
        by the data axes' size.  With ``n_models > 1`` an axis named
        ``'models'`` shards the members (``n_models`` must divide by its
        size); ``predict``, ``save`` and ``export`` see every member.  The
        mesh's first rank writes checkpoints.
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
        with tracing.span("pydens.init"):
            if mesh is not None and not isinstance(mesh, DeviceMesh):
                raise TypeError(
                    "mesh must be a torch.distributed.device_mesh."
                    "DeviceMesh (pydens_tpu_torch.make_mesh()), got "
                    f"{type(mesh).__name__}")
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
            # Data parallelism: every rank of the mesh constructs the Solver
            # and drives it in lockstep (one process a rank).
            self.mesh = mesh
            self._shards = (None if mesh is None
                            else Shards(mesh, self.n_models, self.device))
            self.losses = []
            self.history = []   # one record per fit call
            # Set by load() from a snapshot.
            self.last_balanced_weights = None
            self._step_counter = 0
            self.model = model(**kwargs, ndims=ndims,
                               initial_condition=initial_condition,
                               boundary_condition=boundary_condition,
                               domain=domain, nparams=nparams,
                               device=self.device)
            seed = 0 if seed is None else int(seed)
            self._init_generator = torch.Generator().manual_seed(seed)
            self.model.reset_parameters(self._init_generator)
            self._generator = torch.Generator(device=self.device).manual_seed(
                _sampling_seed(seed, self.device))
            self._opt = None
            self._opt_state = None
            self._pending_opt_state = None   # set by a checkpoint load
            self._opt_cache = {}
            self._step_cache = {}
            self._residual_fn = None

            # Discovery: one real forward of model + equation + constraints
            # on a single row of domain midpoints registers the V variables
            # and records which pure field derivatives the equation takes
            # (the plan).  The constraints run in a context of their own, so
            # D used there does not void the equation's plan.
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
                f = Expr(lambda: self.model.apply_leaves(params, ctx.leaves),
                         ctx, deriv=())
                coords = [Expr(_leaf_fn(ctx, k), ctx, leaf_index=k)
                          for k in range(total)]
                try:
                    residuals = _as_residual_list(self.equation(f, *coords))
                except TypeError as err:
                    if "positional argument" in str(err):
                        raise TypeError(
                            f"equation callable must accept (f, *coords) "
                            f"with {total} coordinate argument(s) — one per "
                            f"variable and one per parameter (ndims={ndims}"
                            f" + nparams={nparams}): {err}") from None
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
            # A separable model's grid taps by forward mode on jets
            # (``SeparableModel.grid_taps``): its grid D without
            # create_graph backward passes, whose results moved with the
            # process's earlier autograd work.
            self._grid_plan_ok = (ctx.plan_ok and bool(ctx.derivs)
                                  and total > 1
                                  and getattr(self.model, "separable",
                                              False))
            self.model.set_variables(registry)
            if getattr(self.model, "separable", False):
                self._probe_grid()
            # Copies: on the CPU the variables share the registry's memory.
            self._initial_variables = {k: np.array(v) for k, v in
                                       registry.items()}
            if self.n_models > 1:
                # The members, drawn from the seed after the discovery run
                # (which ran one model), as reset(seed) draws them.
                self.model.make_ensemble(self.n_models)
                self._init_generator.manual_seed(seed)
                self.model.reset_parameters(self._init_generator)

    def _probe_grid(self):
        """A separable model's grid-shape probe (``pydens_tpu/solver.py:
        389-425``): the equation once on broadcast-shaped axis leaves of
        DISTINCT sizes; a residual that collapses a grid axis is rejected.
        The classic trap is the pointwise component slice ``f[:, 0:1]`` —
        axis 1 of a separable field is a GRID axis; the portable spelling
        ``f[..., k:k+1]`` works for both model kinds."""
        total = self.model.total
        sizes = tuple(2 + k for k in range(total))
        spans = list(self.model.domain) + [(0.0, 1.0)] * self.model.nparams
        leaves = [torch.linspace(
            0.75 * float(lo) + 0.25 * float(hi),
            0.25 * float(lo) + 0.75 * float(hi), sizes[k],
            dtype=self.model.dtype, device=self.device).reshape(
                (1,) * k + (sizes[k],) + (1,) * (total - k)
            ).requires_grad_(True) for k, (lo, hi) in enumerate(spans)]
        params = self.model.params
        with variable_scope("read", params["variables"]):
            ctx = EvalContext(leaves)
            f = Expr(lambda: self.model.apply_leaves(params, ctx.leaves), ctx,
                     deriv=())
            coords = [Expr(_leaf_fn(ctx, k), ctx, leaf_index=k)
                      for k in range(total)]
            shapes = [tuple(as_array(r).shape)
                      for r in _as_residual_list(self.equation(f, *coords))]
        for j, shape in enumerate(shapes):
            if shape[:total] != sizes:
                raise ValueError(
                    f"residual {j} of the equation has shape {shape} "
                    f"on a {sizes} collocation grid — a grid axis was "
                    "collapsed.  On a separable model the field is "
                    "grid-shaped: slice solution components with "
                    "f[..., k:k+1] (not the pointwise f[:, k:k+1]) and "
                    "keep all math elementwise/broadcasting")

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
        with tracing.span("pydens.reset"):
            if seed is not None:
                self._init_generator.manual_seed(int(seed))
                self._generator.manual_seed(_sampling_seed(int(seed),
                                                           self.device))
            self.model.reset_parameters(self._init_generator)
            with torch.no_grad():
                for name, value in self._initial_variables.items():
                    self.model.variable(name).copy_(torch.as_tensor(value))
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

    @property
    def ctx(self):
        """Migration shim for the reference's ``solver.ctx.run(fn, *args)``
        idiom (examples notebook; the reference snapshots a contextvars
        context so ``V`` resolves inside user calls,
        ``model_torch.py:316-317,486``).  The port needs no ambient
        context — V variables live in the model's parameters and the model
        reads them itself — so ``run`` simply invokes the callable:
        ``solver.ctx.run(solver.model, xs)`` is ``solver.model(xs)``."""
        return _CtxShim()

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
        float32 array, with the reference's quirks
        (:func:`~pydens_tpu_torch.utils.inputs.reshape_and_concat`)."""
        return reshape_and_concat(tensors)

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
        batch = max((_numel(x) for x in vals if not is_number(x)),
                    default=1)
        cols = []
        for x in vals:
            if is_number(x):
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
        points are evaluated by every member, ``(K, n, c)``; coordinate
        expressions already hold a row block a member."""
        model = self.model
        K = model.n_models

        def members(xs_c, pts):
            if K == 1 or any(isinstance(p, Expr) for p in pts):
                return xs_c
            return xs_c.repeat(K, 1)

        def per_member(out, pts):
            """Fixed points' member-major rows as ``(K, n, c)``, so that a
            per-point target ``(n, c)`` broadcasts against each member."""
            if K == 1 or any(isinstance(p, Expr) for p in pts):
                return out
            return out.reshape(K, -1, out.shape[-1])

        def fwd(*pts):
            if any(isinstance(p, Expr) for p in pts):
                def fn():
                    vals = [p.value if isinstance(p, Expr) else p
                            for p in pts]
                    return model.apply(params, self._concat_points(vals))
                return Expr(fn, ctx)
            return per_member(model.apply(params, members(
                self._concat_points(list(pts)), pts)), pts)

        def fwd_grad(*pts, wrt=0):
            vals = [p.value if isinstance(p, Expr) else p for p in pts]
            multi = ((wrt,) if isinstance(wrt, (int, np.integer))
                     else tuple(wrt))
            shared = K == 1 or not any(isinstance(p, Expr) for p in pts)
            if (model.supports_taylor and len(multi) <= PLAN_MAX_ORDER
                    and shared):
                # Forward mode written out (the plain traversal and the
                # ansatz on jets), as pydens_tpu's nested jvp: a
                # create_graph backward would add nodes that the device
                # thread numbers after the process's earlier autograd
                # work, and the fit would depend on that work.
                mi = tuple(sorted(multi))
                return per_member(model.full_taps(
                    params, self._concat_points(vals), [mi],
                    plain=True)[mi], pts)
            xs_c = members(self._concat_points(vals), pts)
            cols = [xs_c[:, k:k + 1].detach().requires_grad_(True)
                    for k in range(xs_c.shape[1])]
            with torch.enable_grad():
                out = model.apply(params, torch.cat(cols, dim=1))
                for k in multi:
                    out = _batch_diagonal_grad(out, cols[k])
            return per_member(out, pts)

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
        # This rank's members (all of them but on a mesh's models axis).
        K = model.n_models
        spec = self._spec().with_members(K)
        shards = self._shards
        n_data = 1 if shards is None else shards.n_data
        plan_derivs = self._plan_derivs if use_plan else None
        # A separable model trains on the tensor-product grid of the batch's
        # columns (pydens_tpu/solver.py:1270-1285); one column is a grid of
        # one axis, the pointwise path.
        on_grid = getattr(model, "separable", False) and total > 1

        def term_values(theta, pts, with_equation=eq_weight is not None,
                        with_constraints=True, grid=on_grid):
            """The equation's residuals (None without ``with_equation``)
            and the requested constraints' values at ``theta``; an
            ensemble's ``(K * N, ...)`` member-major rows, the ``N`` points
            repeated for each member, each member's derivative leaves its
            own rows.  With ``grid`` the leaves are the columns of ``pts``
            as broadcast-shaped axes ``(1, .., N, .., 1, 1)``: the residuals
            are ``(N, .., N, c)`` (an ensemble's ``(K, N, .., N, c)``)."""
            params = spec.unflatten(theta)
            with_constraints = with_constraints and bool(nums)
            n = pts.shape[0]
            # The planned taps: the Taylor traversal's, or a separable
            # model's grid taps on jets; nested D otherwise.
            taps = (plan_derivs if grid or model.supports_taylor
                    else None)
            if grid:
                # On a mesh grid axis 0 is sharded: this rank's rows of it.
                cols = [pts[:, k] if k or shards is None
                        else shards.shard(pts[:, 0]) for k in range(total)]
                leaves = [c.reshape((1,) * k + (c.shape[0],)
                                    + (1,) * (total - k))
                          .detach().requires_grad_(
                              taps is None or with_constraints)
                          for k, c in enumerate(cols)]
                scope = member_scope(K, tuple(c.shape[0] for c in cols))
            else:
                rows = pts if K == 1 else pts.repeat(K, 1)
                if taps is None or with_constraints:
                    leaves = [rows[:, k:k + 1].detach().requires_grad_(True)
                              for k in range(total)]
                else:
                    leaves = [rows[:, k:k + 1] for k in range(total)]
                scope = member_scope(K, n)
            residuals, values = None, []
            with variable_scope("read", params["variables"]), scope:
                table = (None if taps is None
                         else model.grid_taps(params, leaves, taps) if grid
                         else model.full_taps(params, pts, taps))
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
            sums are one-hot reductions, in a fixed order (no atomics).  On
            a mesh the bin sums and counts are every rank's, and the term is
            this rank's estimate of the whole batch's (its share of the
            weighted sum, times the ranks)."""
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
            counts = onehot.sum(0)
            if shards is not None:
                sums, counts = shards.sum_parts(sums, counts)
            L = sums / counts.clamp(min=1.0)
            earlier = torch.ones((n_bins, n_bins), dtype=sq.dtype,
                                 device=pts.device).tril(-1)
            cum = (earlier * L).sum(1)
            cum = cum / (cum[-1] + L[-1]).clamp(min=1e-30)
            w = torch.exp(-eps * cum)
            w_pt = w[bins]
            if shards is not None:
                return (n_data * torch.sum(w_pt * sq)
                        / torch.sum(w * counts).clamp(min=1e-30))
            return torch.sum(w_pt * sq) / w_pt.sum().clamp(min=1e-30)

        def causal_grid_term(residuals, pts, eps):
            """Causal weighting on a separable grid
            (``pydens_tpu/solver.py:715-748``): the time axis is a grid
            axis, so each time SAMPLE gets its exact slice-mean squared
            residual L; the weights ``exp(-eps * cumulative earlier L /
            total L)`` over the samples sorted by time, without gradient,
            self-normalized, so eps = 0 is the plain MSE.  An ensemble's
            per member.

            On a mesh grid axis 0 is split over the data ranks (``pts`` is
            the whole batch on every rank).  The slice means are made
            global in one all-reduce before the sort, so every rank sorts
            and weights alike: with time on axis 0 each rank writes its
            slices' means at their offsets in a zero buffer of all N_t
            (disjoint supports: the sum is exact); with time on another
            axis each rank holds every slice over its share of the
            cross-section, and the mean of the ranks' means is the
            slice's.  The term is then this rank's share of the global
            weighted sum over the global denominator, times the ranks
            (the step's all-reduce takes each rank's share)."""
            t_idx = causal[0]
            lead = 0 if K == 1 else 1
            sq = 0.0
            for res in residuals:
                if res.dim() == total + lead:   # component axis already gone
                    res = res[..., None]
                sq = sq + torch.mean(res * res, dim=-1)
            other = tuple(lead + a for a in range(total) if a != t_idx)
            L = torch.mean(sq.detach(), dim=other)      # lead + (N_t,)
            n_t = pts.shape[0]
            mine = slice(0, n_t)
            if shards is not None:
                if t_idx == 0:
                    mine = slice(shards.data_index * L.shape[-1],
                                 (shards.data_index + 1) * L.shape[-1])
                    full = L.new_zeros(L.shape[:-1] + (n_t,))
                    full[..., mine] = L
                    L = full
                elif n_data > 1:
                    L = L * (1.0 / n_data)
                L = shards.sum(L)
            order = torch.argsort(pts[:, t_idx].detach())
            L = L.index_select(-1, order)
            cum = torch.cat([torch.zeros_like(L[..., :1]),
                             torch.cumsum(L, -1)[..., :-1]], dim=-1)
            cum = cum / (cum[..., -1:] + L[..., -1:]).clamp(min=1e-30)
            w = torch.exp(-eps * cum).index_select(-1, torch.argsort(order))
            w_mine = w[..., mine]
            w_b = w_mine.reshape(w.shape[:lead] + (1,) * t_idx + (-1,)
                                 + (1,) * (total - 1 - t_idx))
            n_other = sq[0].numel() if lead else sq.numel()
            n_other //= w_mine.shape[-1]    # this rank's cross-section
            num = torch.sum((w_b * sq).flatten(lead), -1)
            if t_idx == 0 and n_data > 1:
                # This rank's slices of the global sum: n_other is every
                # rank's cross-section, the denominator global.
                num = n_data * num
            return num / (w.sum(-1) * n_other).clamp(min=1e-30)

        def terms(residuals, values, leaf, pts, point_weight=None,
                  causal_eps=None):
            """The unweighted terms, in ``term_order``."""
            out = []
            if residuals is not None and causal is not None and on_grid:
                out.append(causal_grid_term(residuals, pts, causal_eps))
            elif residuals is not None and causal is not None:
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
                                             with_constraints=False,
                                             grid=False)
            return member_mean(_abs_residual(residuals, leaf))

        lead = () if K == 1 else (K,)

        def block(t, ranks=1):
            """A residual or constraint value as one member's flat block
            scaled by ``1/sqrt(size)``, ``(K, size)`` for an ensemble; on a
            mesh the equation's is this rank's rows of a block of
            ``ranks`` times the size."""
            return t.reshape(lead + (-1,)) * (K / (t.numel() * ranks)) ** 0.5

        def blocks(residuals, values):
            out = []
            if residuals is not None:
                out.append(torch.cat([block(r, n_data) for r in residuals],
                                     dim=-1))
            out += [block(c) for c in values]
            return tuple(out)

        def block_layout(residuals, values):
            """Each block's size over every rank of the mesh and the
            indices of this rank's entries in it (None: every rank holds
            the whole block): a member's rows of each residual are
            contiguous, this rank's the ``data_index``-th share."""
            out = []
            if residuals is not None:
                index, at = [], 0
                for r in residuals:
                    m = r.numel() // K
                    index.append(at + shards.data_index * m + torch.arange(
                        m, device=r.device))
                    at += m * n_data
                out.append((at, torch.cat(index)))
            return out + [(c.numel() // K, None) for c in values]

        def term_blocks(theta, pts):
            residuals, values, _ = term_values(theta, pts)
            return blocks(residuals, values)

        def resvec(theta, pts):
            """The stacked residual vector ``r`` with ``loss_fn == r . r``
            for the MSE criterion: the term blocks, each scaled by
            ``sqrt(weight)`` (``resvec_fn`` of ``pydens_tpu/solver.py``),
            for Levenberg-Marquardt."""
            residuals, values, _ = term_values(theta, pts)
            out = [b * w ** 0.5 for b, w in zip(blocks(residuals, values),
                                                weights)]
            if n_data > 1:
                # Every rank holds the constraints whole: each its share,
                # so that the sums over the ranks count them once.
                first = int(residuals is not None)
                out = out[:first] + [b * n_data ** -0.5
                                     for b in out[first:]]
            if not out:
                return theta.new_zeros(lead + (1,))
            return torch.cat(out, dim=-1)

        loss_fn.spec = spec
        loss_fn.total = total
        loss_fn.on_grid = on_grid
        loss_fn.term_order = tuple(zip(term_order, weights))
        loss_fn.evaluate = term_values
        loss_fn.terms = terms
        loss_fn.combine = combine
        loss_fn.blocks = blocks
        loss_fn.block_layout = block_layout
        loss_fn.point_residual = point_residual
        loss_fn.member_mean = member_mean
        loss_fn.term_blocks = term_blocks
        loss_fn.resvec = resvec
        return loss_fn

    def _sample(self, sampler, n, batch_size):
        """``(n, batch_size, total)`` collocation points on the device: the
        default U(0, 1) quirk and samplers with a device path draw from the
        Solver's generator; the others on the host.  A separable model's
        ``batch_size`` is points per axis, and its default sampler draws
        the declared domain (parameter columns U(0, 1)): it has no
        reference quirk to keep (``pydens_tpu/solver.py:998-1011``)."""
        total = self.model.total
        if sampler is None:
            # Reference quirk: U(0, 1) per column, ignoring `domain`.
            pts = torch.rand((n, batch_size, total),
                             generator=self._generator, device=self.device,
                             dtype=self.model.dtype)
            if getattr(self.model, "separable", False):
                dom = (list(self.model.domain)
                       + [(0.0, 1.0)] * self.model.nparams)
                lo, span = (torch.as_tensor(
                    np.asarray(v, np.float32), dtype=self.model.dtype,
                    device=self.device) for v in (
                        [d[0] for d in dom], [d[1] - d[0] for d in dom]))
                pts = lo + span * pts
            return pts
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
        TensorBoard); its ranges name the fit's stages (``pydens.fit.*``,
        :mod:`pydens_tpu_torch.tracing`).

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
        messages.  On a mesh ``batch_size`` must divide by the data axes'
        size and ``n_models`` by the models axis' (``pydens_tpu``'s
        messages), and every rank stops at the same step.
        """
        if int(niters) <= 0:
            return self
        with self._local_members(), _profiled(profile_dir, self.device), \
                tracing.span("pydens.fit") as root:
            return self._fit(niters, batch_size, sampler, loss_terms,
                             optimizer, criterion, lr, losses, progress,
                             chunk_size, resample, adaptive, fast_taps,
                             callback, loss_balancing, checkpoint_path,
                             checkpoint_every, stop_on_nan, causal,
                             causal_axis, rba, until_loss, root, **kwargs)

    @contextlib.contextmanager
    def _local_members(self):
        """On a mesh whose models axis shards the ensemble, the model runs
        this rank's members only while a fit runs (the solver's parameters
        keep every member)."""
        shards = self._shards
        if shards is None or shards.model_axis is None:
            yield
            return
        self.model.n_models = shards.k_local
        try:
            yield
        finally:
            self.model.n_models = self.n_models

    def _local_theta(self):
        """The flat parameters this rank trains."""
        theta = self._spec().flatten(self.model.params)
        return (theta if self._shards is None
                else self._shards.local_members(theta))

    def _full_params(self, theta):
        """The parameter tree of a step's ``theta``, every member of it."""
        if self._shards is not None:
            theta = self._shards.gather_members(theta)
        return self._spec().unflatten(theta)

    def _full_state(self, state):
        """An optimizer state with every member of it."""
        if state is None or self._shards is None:
            return state
        return {k: v if _member_axis(k) is None
                else self._shards.gather_members(v, _member_axis(k))
                for k, v in state.items()}

    def _draw(self, step, sampler, n):
        """``n`` draws of the step's points rows: this rank's slice of each
        batch on a mesh."""
        pts = self._sample(sampler, n, step.pool)
        return self._shards.shard(pts, 1) if step.shard_points else pts

    def _check_mesh(self, batch_size):
        """``pydens_tpu``'s divisibility checks of a mesh fit
        (``solver.py:1772-1785``)."""
        shards = self._shards
        if shards is None:
            return
        if shards.data_axes and batch_size % shards.n_data:
            raise ValueError(
                f"batch_size={batch_size} must be divisible by the data "
                f"mesh axes {shards.data_axes} total size {shards.n_data} "
                "for data-parallel training")
        if shards.model_axis and self.n_models % shards.n_member_ranks:
            raise ValueError(
                f"n_models={self.n_models} must be divisible by the "
                f"'{shards.model_axis}' mesh axis size "
                f"{shards.n_member_ranks}")

    def _fit(self, niters, batch_size, sampler, loss_terms, optimizer, criterion, lr, losses, progress, chunk_size, resample, adaptive, fast_taps, callback, loss_balancing, checkpoint_path, checkpoint_every, stop_on_nan, causal, causal_axis, rba, until_loss, root, **kwargs):
        fit_t0 = time.perf_counter()
        niters = int(niters)
        with tracing.span("pydens.fit.prepare") as prep:
            cached = len(self._step_cache)
            if until_loss is not None:
                until_loss = float(until_loss)
                stop_on_nan = True
            if losses is not None:
                loss_terms = losses
            loss_terms = _normalize_loss_terms(loss_terms)
            criterion_fn, criterion_key = resolve_criterion(criterion)
            fresh_optimizer = optimizer is not None
            if fresh_optimizer:
                # One instance per (optimizer, lr, kwargs), as the JAX
                # package keys it (a schedule by identity): the cached fit
                # steps key on the instance.  The entry keeps the optimizer
                # and lr objects alive, so an id in the token is never
                # reused.
                opt_token = (optimizer if isinstance(optimizer, str)
                             else id(optimizer),
                             float(lr) if isinstance(lr, (int, float))
                             else id(lr),
                             tuple(sorted(kwargs.items())))
                if opt_token not in self._opt_cache:
                    self._opt_cache[opt_token] = (
                        resolve_optimizer(optimizer, lr, kwargs), optimizer,
                        lr)
                self._opt = self._opt_cache[opt_token][0]
            elif self._opt is None:
                raise ValueError("fit(optimizer=None) requires a previous "
                                 "fit call that created an optimizer")
            if fast_taps not in (True, False, "auto", "never", "always"):
                raise ValueError(
                    f"fast_taps={fast_taps!r} is not a recognized value; use "
                    "'auto' or True/'always' (Taylor plan when valid), or "
                    "False/'never' (nested gradients)")
            use_plan = (bool(self._plan_ok or self._grid_plan_ok)
                        and fast_taps not in (False, "never"))
            if isinstance(self._opt, LMConfig):
                self._check_lm(criterion_key, adaptive, causal, rba,
                               loss_balancing)
            options, causal_eps = self._collocation(
                loss_terms, criterion_key, sampler, resample, adaptive, rba,
                causal, causal_axis, loss_balancing)
            batch_size = int(batch_size)
            self._check_mesh(batch_size)
            chunk = max(1, min(niters, int(chunk_size)))
            step = self._fit_step(loss_terms, criterion_fn, use_plan,
                                  batch_size, chunk, bool(resample),
                                  bool(stop_on_nan), options)
            if step.causal_eps is not None:
                step.causal_eps.fill_(causal_eps)
            if step.wts is not None:    # each fit starts from loss_terms
                step.wts.copy_(torch.as_tensor([w for _, w in
                                                step.loss_fn.term_order]))
            if step.rba_w is not None:  # and from no attention
                step.rba_w.fill_(1.0)
            with torch.no_grad():
                step.theta.copy_(self._local_theta())
            if fresh_optimizer or self._opt_state is None:
                self._opt_state = self._opt.init(step.theta.detach())
            for name, value in self._opt_state.items():
                step.state[name].copy_(value)
            self._graft_pending_opt_state(step.state)
            # The guard's predicate, the same on the device and on the
            # host: a loss is good when finite and above tol (-inf without
            # until_loss).
            tol = np.float32(-np.inf if until_loss is None else until_loss)
            if step.armed is not None:
                step.armed.fill_(True)
                step.tol.fill_(float(tol))
            if not step.resample:
                step.points[0].copy_(self._draw(step, sampler, 1)[0])
            if prep is not None:
                prep.attrs["cached"] = len(self._step_cache) == cached
        # The device counter a chunk's span reads while recording: the live
        # CG iterations of LM steps, the linesearch trials of L-BFGS steps.
        live_name = ("cg_iters" if isinstance(self._opt, LMConfig)
                     else "trials" if isinstance(self._opt, LBFGS) else None)
        opt_name = (optimizer if isinstance(optimizer, str)
                    else "reused" if optimizer is None
                    else type(optimizer).__name__)

        bounds = range(0, niters, chunk)
        if progress is True or (progress == "auto" and sys.stderr.isatty()):
            try:
                from tqdm import tqdm
                bounds = tqdm(bounds, unit="chunk")
            except ImportError:
                pass
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
            self._write(checkpoint_path,
                        params=self._full_params(step.theta.detach()),
                        opt_state=self._full_state(step.state),
                        losses=self.losses + fit_losses,
                        step_counter=self._step_counter + iters_run,
                        balanced_weights=balanced_weights())

        try:
            for start in bounds:
                n = min(chunk, niters - start)
                if step.resample:
                    with tracing.span("pydens.fit.draw") as sp:
                        step.points[:n].copy_(self._draw(step, sampler, n))
                        if step.uniforms is not None:
                            step.uniforms[:n].copy_(torch.rand(
                                step.uniforms[:n].shape,
                                generator=self._generator,
                                device=self.device, dtype=self.model.dtype))
                        if sp is not None:
                            sp.attrs["points"] = n * step.pool
                with tracing.span("pydens.fit.steps") as steps_span:
                    if steps_span is not None:
                        tallies = step.tallies()
                        live = (step.live.clone() if live_name is not None
                                else None)
                    step.run(n, start)
                    if steps_span is not None:
                        eager, replays, captures = (
                            now - then for now, then in zip(step.tallies(),
                                                            tallies))
                        steps_span.attrs.update(steps=n, replays=replays,
                                                eager=eager,
                                                captures=captures)
                # The one host read of this chunk.
                with tracing.span("pydens.fit.read"):
                    chunk_losses = step.losses[:n].tolist()
                if steps_span is not None and live is not None:
                    steps_span.attrs[live_name] = int(step.live - live)
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
            with tracing.span("pydens.fit.commit"):
                self._step_counter += iters_run
                self.model.load_params(self._full_params(
                    step.theta.detach()))
                self._opt_state = {k: v.clone()
                                   for k, v in step.state.items()}
                self.losses.extend(fit_losses)
            if root is not None:
                root.attrs.update(niters=niters, steps=iters_run,
                                  batch_size=batch_size,
                                  optimizer=opt_name)

        self.history.append({
            "niters": iters_run, "batch_size": batch_size,
            "optimizer": opt_name,
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

        if getattr(self.model, "separable", False):
            # Tensor-product-grid training: adaptive refinement and RBA
            # weights assume a flat batch of independent points.
            if adaptive is not None:
                raise ValueError("adaptive collocation is per-point; a "
                                 "separable model trains on a tensor-product "
                                 "grid — drop adaptive=")
            if rba_cfg is not None:
                raise ValueError("rba weights are per flat batch point; not "
                                 "supported for separable grid training")

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
                    self._local_theta(), chunk,
                    batch_size, resample, guard, capture)
            kwargs = dict(options=options, generator=self._generator,
                          shards=self._shards)
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
        if self._shards is not None:
            pending = {k: v if _member_axis(k) is None
                       else self._shards.local_members(torch.as_tensor(v),
                                                       _member_axis(k))
                       for k, v in pending.items()}
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
        to ``path`` (:mod:`pydens_tpu_torch.utils.checkpoint`).  On a mesh
        the first rank writes and the others wait for it."""
        self._write(path, opt_state=self._full_state(self._opt_state))

    def _write(self, path, **overrides):
        from .utils.checkpoint import save_solver
        if self._shards is None or self._shards.writer:
            save_solver(self, path, **overrides)
        if self._shards is not None:
            self._shards.barrier()

    def export(self, path=None, with_grad=False):
        """Serialize the trained solution field to a portable ahead-of-time
        serving artifact (``torch.export``): parameters baked in, batch
        dimension dynamic, loadable by :func:`pydens_tpu_torch.
        load_exported` (or by ``torch.export.load`` in a process with torch
        alone) on the CPU or the card.  ``with_grad=True`` makes the
        artifact return ``(u, du)`` with the ``predict_grad`` derivative
        fields.  Returns the artifact bytes (also written to ``path`` if
        given)."""
        from .utils.export import export_model
        return export_model(self, path, with_grad=with_grad)

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
        x = self.model.device_inputs(xs)
        theta = self._spec().flatten(self.model.params)
        with torch.enable_grad():
            out = self._residual_fn(theta.detach(), x)
        return to_host(out)

    def _predict_raw(self, xs):
        return self.model.predict_apply(self.model.params,
                                        self.model.device_inputs(xs))

    def predict(self, *xs):
        """Evaluate the trained solution at the supplied points: arrays,
        numbers (tiled to the batch), lists, or one ``(N, ndims+nparams)``
        array of stacked coordinates.  Returns an ``(N, n_out)`` numpy
        array; the ensemble mean when ``n_models > 1``.  Results come back
        in the model's dtype, a bfloat16 model's as float32 (every results
        method does so).  It is the model call, ``solver.model(*xs)``."""
        return self.model(*xs)

    def predict_all(self, *xs):
        """Every member's prediction, ``(n_models, N, n_out)`` (``(1, N,
        n_out)`` for one model), from one network pass (one MLP launch
        where the chain is in the kernel's scope)."""
        out = self._predict_raw(xs)
        if self.n_models == 1:
            out = out[None]
        return to_host(out)

    def predict_std(self, *xs):
        """The ensemble's pointwise standard deviation over its members
        (numpy's ``ddof=0``), the epistemic uncertainty of the solution,
        ``(N, n_out)``.  Requires ``n_models > 1``."""
        if self.n_models <= 1:
            raise ValueError("predict_std requires Solver(n_models > 1)")
        return to_host(self._predict_raw(xs).std(0, correction=0))

    def predict_grad(self, *xs):
        """First derivatives of the trained solution w.r.t. every coordinate
        (and parameter) column at the supplied points (the inputs of
        :meth:`predict`): flux or velocity fields.

        Returns ``(N, ndims+nparams)`` for scalar problems, ``(N,
        ndims+nparams, n_out)`` for systems; the ensemble mean when
        ``n_models > 1``.  A model with a Taylor plan computes every first
        derivative in one traversal (``Model.full_taps``; on the card one
        launch of the fused Taylor forward kernel); any other takes nested
        ``D``."""
        model, K = self.model, self.n_models
        total = model.total
        x = self.model.device_inputs(xs)
        params = model.params
        with variable_scope("read", params["variables"]):
            if model.supports_taylor:
                with torch.no_grad():
                    table = model.full_taps(params, x,
                                            {(a,) for a in range(total)})
                cols = [table[(a,)] for a in range(total)]
            else:
                rows = x if K == 1 else x.repeat(K, 1)
                leaves = [rows[:, k:k + 1].detach().requires_grad_(True)
                          for k in range(total)]
                with torch.enable_grad():
                    out = model.apply(params, torch.cat(leaves, dim=1))
                    cols = [_batch_diagonal_grad(out, leaf).detach()
                            for leaf in leaves]
        g = torch.stack(cols, dim=1)        # (K * N, total, n_out)
        if K > 1:
            g = g.reshape((K, -1) + g.shape[1:]).mean(0)
        g = to_host(g)
        return g[..., 0] if g.shape[-1] == 1 else g

    def predict_grid(self, *axes):
        """Evaluate the trained solution on the tensor-product grid of the
        given 1-D per-axis arrays; returns ``(N_1, ..., N_d, n_out)``.

        A :class:`~pydens_tpu_torch.SeparableModel` takes the factorized
        path: ``d`` small MLP evaluations and one ``torch.einsum``, network
        work that grows with the axes' lengths, not with their product; an
        ensemble's is the member mean.  Other models take ``meshgrid`` and
        :meth:`predict` (pointwise cost)."""
        model, K = self.model, self.n_models
        total = model.total
        if len(axes) != total:
            raise ValueError(f"predict_grid needs one 1-D array per input "
                             f"column ({total}), got {len(axes)}")
        axes = [np.asarray(a, np.float32).ravel() for a in axes]
        if not getattr(model, "separable", False) or total == 1:
            grids = np.meshgrid(*axes, indexing="ij")
            out = self.predict(*[g.ravel() for g in grids])
            return out.reshape(grids[0].shape + (out.shape[-1],))
        leaves = [torch.as_tensor(a, dtype=model.dtype, device=self.device)
                  .reshape((1,) * k + (-1,) + (1,) * (total - k))
                  for k, a in enumerate(axes)]
        params = model.params
        with torch.no_grad(), variable_scope("read", params["variables"]):
            out = model.apply_leaves(params, leaves)
        return to_host(out.mean(0) if K > 1 else out)
