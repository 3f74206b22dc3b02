"""Point samplers, counterpart of ``pydens_tpu/samplers.py``.

Protocol: ``sampler.sample(size) -> np.ndarray`` of shape ``(size, ndims)``
(the host path), plus the ``&`` product and the rest of the sampler
algebra.  The host path is the JAX package's numpy code, call for call on
the same ``np.random.default_rng(seed)``, so it returns the same numbers.

Every built-in sampler whose JAX counterpart has a device path also has
``sample_device(generator, size)``: float32 points drawn with the Solver's
``torch.Generator`` on that generator's device, which the Solver calls once
per chunk so the training loop never waits for host sampling.  Where the
JAX package splits a key, the children here draw in order from the one
generator.  Samplers that only implement ``sample`` still work: the Solver
draws their points on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Sampler", "NumpySampler", "ConstantSampler", "HistoSampler",
           "ScipySampler", "ProductSampler", "MixtureSampler", "NS",
           "GeometrySampler", "BoundarySampler", "HaltonSampler"]


class Sampler:
    """Base sampler.

    Subclasses set ``ndims`` and implement :meth:`sample` (host, numpy) and
    optionally :meth:`sample_device` (device, ``torch.Generator``).

    Composition:

    * ``a & b`` — product: joint sampler over ``a.ndims + b.ndims`` columns.
    * ``a | b`` — mixture: rows drawn from ``a`` or ``b`` (weights via
      ``w * sampler``).
    * ``w * sampler`` (scalar) — re-weights a mixture component.
    * ``a + b``, ``a - b``, ``a / b``, ``a.times(b)``, ``shift``, ``scale``
      — pointwise algebra on samples.
    * ``sampler.apply(fn)`` — host-side transform of sampled points.
    * ``sampler.truncate(low, high)`` — host-side rejection resampling.
    """

    ndims = 1
    weight = 1.0

    # -- protocol -----------------------------------------------------------
    def sample(self, size):
        raise NotImplementedError

    def sample_device(self, generator, size):
        raise NotImplementedError(
            f"{type(self).__name__} has no device-side sampling path")

    @property
    def supports_device(self):
        return type(self).sample_device is not Sampler.sample_device

    # -- composition --------------------------------------------------------
    def __and__(self, other):
        return ProductSampler(self, other)

    def __or__(self, other):
        return MixtureSampler([self, other])

    def __mul__(self, w):
        if isinstance(w, (int, float)):
            return _Weighted(self, float(w))
        return NotImplemented

    __rmul__ = __mul__

    def __add__(self, other):
        return BinOpSampler(self, other, "add")

    __radd__ = __add__

    def __sub__(self, other):
        return BinOpSampler(self, other, "sub")

    def __rsub__(self, other):
        return BinOpSampler(self, other, "rsub")

    def __truediv__(self, other):
        return BinOpSampler(self, other, "div")

    def times(self, other):
        """Elementwise product of samples (``*`` is reserved for mixture
        weights, so the sample-algebra product is a named method)."""
        return BinOpSampler(self, other, "mul")

    def shift(self, c):
        """Samples shifted by a constant."""
        return BinOpSampler(self, c, "add")

    def scale(self, c):
        """Samples scaled by a constant."""
        return BinOpSampler(self, c, "mul")

    def apply(self, fn):
        """Host-side pointwise transform: ``fn(points) -> points``."""
        return MappedSampler(self, fn)

    def truncate(self, low=None, high=None, max_tries=100):
        """Rejection-resample until all coordinates fall in ``[low, high]``
        (host only)."""
        return TruncatedSampler(self, low, high, max_tries)


class _Weighted(Sampler):
    """Internal: a sampler with a mixture weight attached."""

    def __init__(self, base, weight):
        self.base = base
        self.ndims = base.ndims
        self.weight = weight

    def sample(self, size):
        return self.base.sample(size)

    def sample_device(self, generator, size):
        return self.base.sample_device(generator, size)

    @property
    def supports_device(self):
        return self.base.supports_device


# ---------------------------------------------------------------------------
# Distribution registry
# ---------------------------------------------------------------------------

def _rand(generator, shape):
    return torch.rand(shape, generator=generator, device=generator.device)


def _randn(generator, shape):
    return torch.randn(shape, generator=generator, device=generator.device)


def _gamma_dev(generator, shape, alpha):
    """Gamma(``alpha``, 1) draws on the generator's device:
    Marsaglia–Tsang (2000) with rejection for ``alpha >= 1``, and
    ``G(alpha + 1) * U ** (1 / alpha)`` below it.  Each round redraws only
    where a candidate was rejected; the host learns whether any is left
    once every four rounds (more than 95% of candidates are accepted)."""
    alpha = float(alpha)
    if alpha <= 0.0:
        raise ValueError(f"gamma shape must be positive, got {alpha}")
    boost = alpha < 1.0
    d = (alpha + 1.0 if boost else alpha) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, device=generator.device)
    pending = torch.ones(shape, dtype=torch.bool, device=generator.device)
    while True:
        for _ in range(4):
            x = _randn(generator, shape)
            v = (1.0 + c * x) ** 3
            u = _rand(generator, shape)
            ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                            + d * torch.log(v.clamp_min(1e-30)))
            take = pending & ok
            out = torch.where(take, d * v, out)
            pending = pending & ~ok
        if not bool(pending.any()):
            break
    if boost:
        out = out * _rand(generator, shape) ** (1.0 / alpha)
    return out


def _u_host(rng, size, dim, low, high):
    return rng.uniform(low, high, (size, dim))


def _u_dev(generator, size, dim, low, high):
    return _rand(generator, (size, dim)) * (high - low) + low


def _n_host(rng, size, dim, loc, scale):
    return rng.normal(loc, scale, (size, dim))


def _n_dev(generator, size, dim, loc, scale):
    return _randn(generator, (size, dim)) * scale + loc


def _e_host(rng, size, dim, scale):
    return rng.exponential(scale, (size, dim))


def _e_dev(generator, size, dim, scale):
    return torch.empty((size, dim), device=generator.device).exponential_(
        generator=generator) * scale


def _b_host(rng, size, dim, a, b):
    return rng.beta(a, b, (size, dim))


def _b_dev(generator, size, dim, a, b):
    g1 = _gamma_dev(generator, (size, dim), a)
    g2 = _gamma_dev(generator, (size, dim), b)
    return g1 / (g1 + g2)


def _g_host(rng, size, dim, shape, scale):
    return rng.gamma(shape, scale, (size, dim))


def _g_dev(generator, size, dim, shape, scale):
    return _gamma_dev(generator, (size, dim), shape) * scale


def _ln_host(rng, size, dim, mean, sigma):
    return rng.lognormal(mean, sigma, (size, dim))


def _ln_dev(generator, size, dim, mean, sigma):
    return torch.exp(_randn(generator, (size, dim)) * sigma + mean)


_DISTRIBUTIONS = {
    "uniform": (_u_host, _u_dev, {"low": 0.0, "high": 1.0}),
    "normal": (_n_host, _n_dev, {"loc": 0.0, "scale": 1.0}),
    "exponential": (_e_host, _e_dev, {"scale": 1.0}),
    "beta": (_b_host, _b_dev, {"a": 1.0, "b": 1.0}),
    "gamma": (_g_host, _g_dev, {"shape": 1.0, "scale": 1.0}),
    "lognormal": (_ln_host, _ln_dev, {"mean": 0.0, "sigma": 1.0}),
}

_ALIASES = {
    "u": "uniform",
    "n": "normal",
    "gaussian": "normal",
    "e": "exponential",
    "b": "beta",
    "g": "gamma",
    "ln": "lognormal",
}


class NumpySampler(Sampler):
    """Sampler over a named distribution: ``NumpySampler('uniform', low=1,
    high=5)``, ``NumpySampler('u', dim=2)``.

    Parameters
    ----------
    name : str
        Distribution name or alias: ``'u'/'uniform'``, ``'n'/'normal'``,
        ``'e'/'exponential'``, ``'b'/'beta'``, ``'g'/'gamma'``,
        ``'ln'/'lognormal'``.
    dim : int
        Number of i.i.d. output columns.
    seed : int, optional
        Host-side RNG seed (the device path draws from the Solver's
        generator).
    **kwargs
        Distribution parameters (e.g. ``low``/``high``, ``loc``/``scale``).
    """

    def __init__(self, name, dim=1, seed=None, **kwargs):
        canonical = _ALIASES.get(name, name)
        if canonical not in _DISTRIBUTIONS:
            raise ValueError(
                f"unknown distribution {name!r}; known: "
                f"{sorted(_DISTRIBUTIONS) + sorted(_ALIASES)}")
        host_fn, dev_fn, defaults = _DISTRIBUTIONS[canonical]
        unknown = set(kwargs) - set(defaults)
        if unknown:
            raise ValueError(f"{canonical} sampler got unexpected "
                             f"parameters {sorted(unknown)}; "
                             f"accepts {sorted(defaults)}")
        self.name = canonical
        self.ndims = int(dim)
        self.params = {**defaults, **kwargs}
        self._host_fn = host_fn
        self._dev_fn = dev_fn
        self._rng = np.random.default_rng(seed)

    def sample(self, size):
        return self._host_fn(self._rng, size, self.ndims, **self.params)

    def sample_device(self, generator, size):
        return self._dev_fn(generator, size, self.ndims, **self.params)


NS = NumpySampler  # tutorial shorthand (`from pydens import NumpySampler as NS`)


class ConstantSampler(Sampler):
    """Sampler returning a constant point."""

    def __init__(self, constant):
        self.constant = np.atleast_1d(np.asarray(constant, np.float32))
        self.ndims = self.constant.shape[-1]

    def sample(self, size):
        return np.tile(self.constant.reshape(1, -1), (size, 1))

    def sample_device(self, generator, size):
        return torch.as_tensor(self.constant.reshape(1, -1),
                               device=generator.device).repeat(size, 1)


class ScipySampler(Sampler):
    """Sampler over a ``scipy.stats`` distribution (host only)."""

    def __init__(self, name, dim=1, seed=None, **kwargs):
        import scipy.stats
        self.dist = getattr(scipy.stats, name)(**kwargs)
        self.ndims = int(dim)
        self._rng = np.random.default_rng(seed)

    def sample(self, size):
        out = self.dist.rvs(size=(size, self.ndims),
                            random_state=self._rng)
        return np.asarray(out, np.float64).reshape(size, self.ndims)


class HistoSampler(Sampler):
    """Sampler from an n-d histogram: pick a bin by its mass, then sample
    uniformly inside it.

    Parameters
    ----------
    histo : tuple
        ``(H, edges)`` as returned by ``np.histogramdd``.
    """

    def __init__(self, histo, seed=None):
        counts, edges = histo
        counts = np.asarray(counts, np.float64)
        self.edges = [np.asarray(e, np.float64) for e in edges]
        self.ndims = counts.ndim
        total = counts.sum()
        if total <= 0:
            raise ValueError("histogram has no mass")
        self.probs = (counts / total).ravel()
        self.bin_shape = counts.shape
        self._rng = np.random.default_rng(seed)
        # Per-flat-bin lower corners and upper corners for the device path.
        idx = np.stack(np.unravel_index(np.arange(self.probs.size),
                                        self.bin_shape), axis=-1)
        self._lo = np.stack([self.edges[d][idx[:, d]]
                             for d in range(self.ndims)], axis=-1)
        self._hi = np.stack([self.edges[d][idx[:, d] + 1]
                             for d in range(self.ndims)], axis=-1)

    def sample(self, size):
        flat = self._rng.choice(self.probs.size, size=size, p=self.probs)
        u = self._rng.uniform(size=(size, self.ndims))
        return self._lo[flat] + u * (self._hi[flat] - self._lo[flat])

    def sample_device(self, generator, size):
        dev = generator.device
        probs = torch.as_tensor(self.probs, dtype=torch.float32, device=dev)
        flat = torch.multinomial(probs, size, replacement=True,
                                 generator=generator)
        u = _rand(generator, (size, self.ndims))
        lo = torch.as_tensor(self._lo, dtype=torch.float32, device=dev)[flat]
        hi = torch.as_tensor(self._hi, dtype=torch.float32, device=dev)[flat]
        return lo + u * (hi - lo)


_HALTON_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47,
                  53, 59, 61, 67, 71)


class HaltonSampler(Sampler):
    """Low-discrepancy (quasi-Monte-Carlo) collocation sampler — the Halton
    sequence with a per-draw random Cranley–Patterson rotation.

    Multi-dim domains should use ONE sampler with ``dim=n`` (and per-dim
    ``low``/``high`` sequences): each column then gets its own prime base.
    Two HaltonSamplers joined with ``&`` would reuse base 2 for both
    columns, putting every point on one wrapped diagonal;
    :class:`ProductSampler` detects this and raises.  For deliberate
    composition pass disjoint ``base_index`` offsets.

    The device path restarts the sequence index at 0 on every draw (only
    the rotation is fresh), as the JAX package's does.

    Parameters
    ----------
    dim : int
        Number of columns (consecutive prime bases; dim <= 20).
    low, high : float or per-dim sequences
        Domain box to scale into (default unit box).
    seed : int, optional
        Host-path RNG seed for the rotation.
    base_index : int
        Offset into the prime-base list.
    """

    def __init__(self, dim=1, low=0.0, high=1.0, seed=None, base_index=0):
        self.ndims = int(dim)
        self.base_index = int(base_index)
        if self.base_index + self.ndims > len(_HALTON_PRIMES):
            raise ValueError(
                f"HaltonSampler supports up to {len(_HALTON_PRIMES)} prime "
                f"bases; got dim={dim} at base_index={base_index}")
        self.low = np.broadcast_to(
            np.asarray(low, np.float32), (self.ndims,)).copy()
        self.high = np.broadcast_to(
            np.asarray(high, np.float32), (self.ndims,)).copy()
        self._bases = _HALTON_PRIMES[self.base_index:
                                     self.base_index + self.ndims]
        # Static digit counts: base ** digits covers every int32 index.
        self._digits = [int(np.ceil(31 / np.log2(b))) for b in self._bases]
        self._rng = np.random.default_rng(seed)
        self._counter = 0

    def _radical_inverse(self, n, d, to_f32):
        """Radical inverse of the integer vector ``n`` in the d-th prime
        base; ``to_f32`` casts a digit vector to float32."""
        base = self._bases[d]
        inv = n * 0.0
        f = 1.0 / base
        for _ in range(self._digits[d]):
            inv = inv + to_f32(n % base) * np.float32(f)
            n = n // base
            f /= base
        return inv

    def sample(self, size):
        idx = np.arange(self._counter, self._counter + size, dtype=np.int64)
        self._counter += size
        shift = self._rng.uniform(size=self.ndims).astype(np.float32)
        cols = [(self._radical_inverse(idx, d, lambda v: v.astype(np.float32))
                 + shift[d]) % 1.0 for d in range(self.ndims)]
        return self.low + np.stack(cols, axis=-1) * (self.high - self.low)

    def sample_device(self, generator, size):
        dev = generator.device
        shift = _rand(generator, (self.ndims,))
        idx = torch.arange(size, dtype=torch.int64, device=dev)
        cols = [(self._radical_inverse(idx, d, lambda v: v.float())
                 + shift[d]) % 1.0 for d in range(self.ndims)]
        low = torch.as_tensor(self.low, device=dev)
        high = torch.as_tensor(self.high, device=dev)
        return low + torch.stack(cols, dim=-1) * (high - low)


class GeometrySampler(Sampler):
    """Collocation points on a geometry given by an indicator function —
    non-rectangular domains (boundary conditions there are constraints with
    boundary samplers).

    Parameters
    ----------
    inside : callable
        ``inside(points) -> bool array`` over ``(N, ndims)`` points; it
        must accept torch tensors for the device path (numpy suffices for
        host-only use).
    bbox : sequence of (lo, hi)
        Bounding box to propose candidates from.
    oversample : int
        Candidate multiplier.  Host sampling rejects and redraws until the
        batch is full; device sampling draws ``oversample * size``
        candidates once and fills the batch with the valid ones in order —
        if fewer than ``size`` land inside, valid points repeat, and if
        none does, the batch is NaN.

    Example (unit disk)::

        disk = GeometrySampler(lambda p: (p ** 2).sum(-1) <= 1.0,
                               bbox=[(-1, 1), (-1, 1)])
    """

    def __init__(self, inside, bbox, oversample=4, seed=None):
        self.inside = inside
        self.bbox = [tuple(map(float, b)) for b in bbox]
        self.ndims = len(self.bbox)
        self.oversample = int(oversample)
        self._rng = np.random.default_rng(seed)

    def _propose_host(self, n):
        lo = np.asarray([b[0] for b in self.bbox])
        hi = np.asarray([b[1] for b in self.bbox])
        return self._rng.uniform(lo, hi, (n, self.ndims))

    def sample(self, size):
        out = np.empty((0, self.ndims), np.float64)
        for _ in range(100):
            cand = self._propose_host(self.oversample * size)
            mask = np.asarray(self.inside(cand)).astype(bool).reshape(-1)
            out = np.vstack([out, cand[mask]])
            if len(out) >= size:
                return out[:size]
        raise RuntimeError(
            "GeometrySampler: indicator accepted too few points — is the "
            "bbox right?")

    def sample_device(self, generator, size):
        dev = generator.device
        n_cand = self.oversample * size
        lo = torch.tensor([b[0] for b in self.bbox], device=dev)
        hi = torch.tensor([b[1] for b in self.bbox], device=dev)
        cand = _rand(generator, (n_cand, self.ndims)) * (hi - lo) + lo
        valid = torch.as_tensor(self.inside(cand),
                                device=dev).reshape(-1).bool()
        # Stable compaction: valid candidates first, in draw order; the
        # batch cycles through them.
        order = torch.argsort((~valid).to(torch.int32), stable=True)
        n_valid = valid.sum()
        take = torch.arange(size, device=dev) % n_valid.clamp_min(1)
        picked = cand[order[take]]
        # No valid candidate must be visible: a NaN batch makes the loss
        # NaN at once instead of training on out-of-domain points.
        return torch.where(n_valid > 0, picked,
                           torch.full_like(picked, float("nan")))

    def duplication_rate(self, size, trials=16):
        """Diagnostic: expected fraction of a device-sampled batch of
        ``size`` points that is duplicate-filled because fewer than ``size``
        of the ``oversample * size`` candidates landed inside.  Uses its own
        RNG, so the sampler's seeded stream is unaffected."""
        rng = np.random.default_rng(0)
        lo = np.asarray([b[0] for b in self.bbox])
        hi = np.asarray([b[1] for b in self.bbox])
        rates = []
        for _ in range(trials):
            cand = rng.uniform(lo, hi, (self.oversample * size, self.ndims))
            valid = np.asarray(self.inside(cand)).astype(bool).reshape(-1)
            n_valid = int(valid.sum())
            rates.append(max(0, size - n_valid) / size)
        return float(np.mean(rates))


class BoundarySampler(Sampler):
    """Points on a parametrized boundary: ``surface(u) -> (N, ndims)`` maps
    uniform samples on ``[0, 1]^udim`` onto the boundary.

    Example (unit circle)::

        circle = BoundarySampler(
            lambda u: torch.cat([torch.cos(2 * np.pi * u),
                                 torch.sin(2 * np.pi * u)], dim=1),
            ndims=2)
    """

    def __init__(self, surface, ndims, udim=1, seed=None):
        self.surface = surface
        self.ndims = int(ndims)
        self.udim = int(udim)
        self._rng = np.random.default_rng(seed)

    def sample(self, size):
        u = self._rng.uniform(size=(size, self.udim))
        return np.asarray(self.surface(u)).reshape(size, self.ndims)

    def sample_device(self, generator, size):
        u = _rand(generator, (size, self.udim))
        return torch.as_tensor(self.surface(u), dtype=torch.float32,
                               device=generator.device).reshape(size,
                                                                self.ndims)


class ProductSampler(Sampler):
    """Joint sampler over concatenated columns — the ``&`` operator."""

    def __init__(self, *samplers):
        flat = []
        for s in samplers:
            if isinstance(s, ProductSampler):
                flat.extend(s.samplers)
            else:
                flat.append(s)
        self.samplers = flat
        self.ndims = sum(s.ndims for s in flat)
        # Two Halton children sharing a prime base give perfectly
        # correlated columns: fail fast.
        used = {}
        for s in flat:
            if isinstance(s, HaltonSampler):
                for b in s._bases:
                    if b in used:
                        raise ValueError(
                            f"HaltonSampler base collision in '&' product "
                            f"(prime base {b} used twice): columns would be "
                            "perfectly correlated. Use ONE HaltonSampler("
                            "dim=n, low=[...], high=[...]) for the joint "
                            "box, or give each component a disjoint "
                            "base_index.")
                    used[b] = s

    def sample(self, size):
        return np.hstack([s.sample(size) for s in self.samplers])

    def sample_device(self, generator, size):
        return torch.cat([s.sample_device(generator, size)
                          for s in self.samplers], dim=1)

    @property
    def supports_device(self):
        return all(s.supports_device for s in self.samplers)


class MixtureSampler(Sampler):
    """Row-wise mixture — the ``|`` operator; component weights come from
    ``w * sampler``."""

    def __init__(self, samplers, seed=None):
        flat = []
        for s in samplers:
            if isinstance(s, MixtureSampler):
                flat.extend(s.samplers)
            else:
                flat.append(s)
        self.samplers = flat
        dims = {s.ndims for s in flat}
        if len(dims) != 1:
            raise ValueError(f"mixture components must share ndims, got {dims}")
        self.ndims = dims.pop()
        w = np.asarray([s.weight for s in flat], np.float64)
        self.weights = w / w.sum()
        self._rng = np.random.default_rng(seed)

    def sample(self, size):
        comp = self._rng.choice(len(self.samplers), size=size,
                                p=self.weights)
        out = np.empty((size, self.ndims), np.float64)
        for i, s in enumerate(self.samplers):
            mask = comp == i
            n = int(mask.sum())
            if n:
                out[mask] = s.sample(n)
        return out

    def sample_device(self, generator, size):
        weights = torch.as_tensor(self.weights, dtype=torch.float32,
                                  device=generator.device)
        comp = torch.multinomial(weights, size, replacement=True,
                                 generator=generator)
        draws = torch.stack([s.sample_device(generator, size)
                             for s in self.samplers])
        return torch.gather(
            draws, 0, comp.view(1, size, 1).expand(1, size, self.ndims))[0]

    @property
    def supports_device(self):
        return all(s.supports_device for s in self.samplers)


class BinOpSampler(Sampler):
    """Pointwise algebra on samples: sampler (+,-,/,times) sampler-or-scalar.

    Operands draw independently; the device path exists when both operands
    have one.
    """

    _OPS = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
            "rsub": lambda a, b: b - a, "mul": lambda a, b: a * b,
            "div": lambda a, b: a / b}

    def __init__(self, left, right, op):
        self.left = left
        self.right = right
        self.op = self._OPS[op]
        if isinstance(right, Sampler) and right.ndims != left.ndims:
            raise ValueError(
                f"sample algebra needs matching ndims, got {left.ndims} "
                f"and {right.ndims}")
        self.ndims = left.ndims

    def sample(self, size):
        rhs = (self.right.sample(size) if isinstance(self.right, Sampler)
               else self.right)
        return self.op(self.left.sample(size), rhs)

    def sample_device(self, generator, size):
        lhs = self.left.sample_device(generator, size)
        rhs = (self.right.sample_device(generator, size)
               if isinstance(self.right, Sampler) else self.right)
        return self.op(lhs, rhs)

    @property
    def supports_device(self):
        rs = (self.right.supports_device if isinstance(self.right, Sampler)
              else True)
        return self.left.supports_device and rs


class MappedSampler(Sampler):
    """Host-side pointwise transform of another sampler."""

    def __init__(self, base, fn):
        self.base = base
        self.fn = fn
        # The mapped width is known now, so compositions built before the
        # first draw size themselves right: probe with zeros, or with one
        # real draw for functions that reject them.
        try:
            probe = np.asarray(fn(np.zeros((1, base.ndims), np.float32)))
        except Exception:
            probe = np.asarray(fn(base.sample(1)))
        self.ndims = int(probe.shape[-1])

    def sample(self, size):
        out = np.asarray(self.fn(self.base.sample(size)))
        self.ndims = out.shape[-1]
        return out


class TruncatedSampler(Sampler):
    """Rejection-resampling truncation of another sampler (host only)."""

    def __init__(self, base, low, high, max_tries=100):
        self.base = base
        self.low = low
        self.high = high
        self.max_tries = max_tries
        self.ndims = base.ndims

    def _ok(self, pts):
        ok = np.ones(len(pts), bool)
        if self.low is not None:
            ok &= np.all(pts >= self.low, axis=1)
        if self.high is not None:
            ok &= np.all(pts <= self.high, axis=1)
        return ok

    def sample(self, size):
        out = np.empty((0, self.ndims), np.float64)
        for _ in range(self.max_tries):
            pts = self.base.sample(size)
            out = np.vstack([out, pts[self._ok(pts)]])
            if len(out) >= size:
                return out[:size]
        raise RuntimeError(
            f"truncate: {self.max_tries} rounds of rejection sampling did "
            "not produce enough in-range points")
