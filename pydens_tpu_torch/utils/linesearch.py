"""The zoom linesearch of optax 0.2.6, on one flat parameter vector.

The port's own copy of ``optax.scale_by_zoom_linesearch(
max_linesearch_steps=20, initial_guess_strategy='one')`` with its other
defaults (``optax/_src/linesearch.py``: ``zoom_linesearch``, ``_cubicmin``,
``_quadmin``): Algorithms 3.5 and 3.6 of Nocedal and Wright, with Hager and
Zhang's approximate decrease criterion.  Its state is a dict of device
tensors updated in place, so the search runs inside a captured CUDA graph:
each iteration computes the candidate stepsize of both phases (the interval
search and the zoom), evaluates the objective ONCE at the one its state
selects, and computes both phases' new state, each ``jax.lax.cond`` of optax
becoming a ``torch.where``.  An iteration is a no-op once the search has
ended (``active`` false), so the caller may stop calling it when the host
reads ``active``, or run a fixed number of iterations without reading
anything.

An ensemble's ``(K, P)`` parameters search per member, as ``jax.vmap`` of
optax's search does: every scalar of the state is ``(K,)``, each member
has its own stepsize and ends on its own, and a member that is done keeps
its state while the others go on.
"""

import torch

__all__ = ["ZoomLinesearch", "dot", "col", "where"]


def dot(a, b):
    """``a . b`` over the last axis: 0-d for vectors (``torch.dot``), one
    value a member for an ensemble's ``(K, P)`` rows."""
    return torch.dot(a, b) if a.dim() == 1 else (a * b).sum(-1)


def col(c):
    """A per-member scalar as a column that scales ``(K, P)`` rows (a 0-d
    one as ``(1,)``, the same product for a vector)."""
    return c[..., None]


def where(c, a, b, out=None):
    """``torch.where`` with a per-member condition ``c`` broadcast over the
    trailing axes of the operands (vectors of one model, rows of an
    ensemble)."""
    dims = max(t.dim() for t in (a, b) if torch.is_tensor(t))
    if c.dim() < dims and c.dim() > 0:
        c = c.reshape(c.shape + (1,) * (dims - c.dim()))
    return torch.where(c, a, b, out=out)

# The scalar fields of the search state (optax's ZoomLinesearchState), each
# a 0-d float tensor, and the bool flags.
_SCALARS = ("stepsize", "value", "slope", "value_init", "slope_init",
            "decrease_error", "curvature_error", "error", "low", "value_low",
            "slope_low", "high", "value_high", "slope_high", "cubic_ref",
            "value_cubic_ref", "safe_stepsize", "safe_value")
_FLAGS = ("interval_found", "done", "failed", "active")


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """A critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where there is none (optax's ``_cubicmin``)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    u = fb - fa - C * db
    v = fc - fa - C * dc
    A = (dc * dc * u + -(db * db) * v) / denom
    B = (-(dc * dc * dc) * u + db * db * db * v) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a (optax's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


class ZoomLinesearch:
    """Zoom linesearch ensuring sufficient decrease and small curvature,
    with the arguments ``pydens_tpu``'s L-BFGS gives optax (its defaults
    but for the iteration limit).

    :meth:`buffers` allocates the state; :meth:`start` sets it for a
    direction ``updates`` at ``params`` (value and gradient there);
    :meth:`step` runs one iteration, evaluating ``value_and_grad`` once.
    ``state["stepsize"]`` is the chosen stepsize once ``state["active"]`` is
    false, and ``state["count"]`` the number of iterations taken."""

    max_linesearch_steps = 20
    tol = 0.0
    increase_factor = 2.0
    slope_rtol = 1e-4
    curv_rtol = 0.9
    approx_dec_rtol = 1e-6
    interval_threshold = 1e-5   # stepsize_precision

    def buffers(self, theta):
        """The search state for a flat vector like ``theta`` (an
        ensemble's ``(K, P)``: each scalar ``(K,)``)."""
        dev, dtype = theta.device, theta.dtype
        lead = tuple(theta.shape[:-1])
        state = {name: torch.zeros(lead, dtype=dtype, device=dev)
                 for name in _SCALARS}
        state.update({name: torch.zeros(lead, dtype=torch.bool, device=dev)
                      for name in _FLAGS})
        state["count"] = torch.zeros(lead, dtype=torch.int32, device=dev)
        for name in ("params", "updates", "grad", "safe_grad"):
            state[name] = torch.zeros_like(theta)
        return state

    @torch.no_grad()
    def start(self, state, updates, params, value, grad):
        """optax's ``init_fn`` with the initial guess 1 (``'one'``)."""
        slope = dot(updates, grad)
        inf = float("inf")
        for name, v in (("params", params), ("updates", updates),
                        ("grad", grad), ("safe_grad", grad),
                        ("value", value), ("value_init", value),
                        ("value_low", value), ("value_high", value),
                        ("value_cubic_ref", value), ("safe_value", value),
                        ("slope", slope), ("slope_init", slope),
                        ("slope_low", slope), ("slope_high", slope)):
            state[name].copy_(v)
        for name in ("stepsize", "low", "high", "cubic_ref", "safe_stepsize"):
            state[name].zero_()
        for name in ("decrease_error", "curvature_error", "error"):
            state[name].fill_(inf)
        for name in ("interval_found", "done", "failed"):
            state[name].fill_(False)
        state["active"].fill_(True)
        state["count"].zero_()

    def _decrease_error(self, stepsize, value, slope, value_init,
                        slope_init):
        err = value - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope - (2 * self.slope_rtol - 1.0) * slope_init
        delta = value - value_init - self.approx_dec_rtol * torch.abs(
            value_init)
        err = torch.minimum(torch.maximum(approx, delta), err)
        err = torch.clamp_min(err, 0.0)
        return torch.where(torch.isnan(err), float("inf"), err)

    def _curvature_error(self, slope, slope_init):
        err = torch.clamp_min(
            torch.abs(slope) - self.curv_rtol * torch.abs(slope_init), 0.0)
        return torch.where(torch.isnan(err), float("inf"), err)

    def _zoom_point(self, s):
        """The zoom's next stepsize: cubic, else quadratic, else bisection
        (Algorithm 3.6)."""
        low, high = s["low"], s["high"]
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        cubic = _cubicmin(low, s["value_low"], s["slope_low"], high,
                          s["value_high"], s["cubic_ref"],
                          s["value_cubic_ref"])
        use_cubic = (cubic > left + 0.2 * delta) & (cubic < right
                                                     - 0.2 * delta)
        quad = _quadmin(low, s["value_low"], s["slope_low"], high,
                        s["value_high"])
        use_quad = ~use_cubic & (quad > left + 0.1 * delta) & (
            quad < right - 0.1 * delta)
        middle = torch.where(use_cubic, cubic, s["cubic_ref"])
        middle = torch.where(use_quad, quad, middle)
        return torch.where(~use_cubic & ~use_quad, (low + high) / 2.0,
                           middle), delta

    def step(self, state, value_and_grad):
        """One iteration in place, where ``state["active"]``: the interval
        search (``_search_interval``) or the zoom (``_zoom_into_interval``)
        by ``interval_found``, then ``_try_safe_step`` if it failed.
        ``value_and_grad(point) -> (value, grad)`` is called once.  Returns a
        0-d bool tensor: whether the search was live at this iteration."""
        s = state
        with torch.no_grad():
            was = s["active"].clone()
            it = s["count"]
            search_at = torch.where(it == 0, 1.0,
                                    self.increase_factor * s["stepsize"])
            zoom_at, delta = self._zoom_point(s)
            zoom = s["interval_found"]
            eta = torch.where(zoom, zoom_at, search_at)
            point = s["params"] + col(eta) * s["updates"]
        value, grad = value_and_grad(point)
        with torch.no_grad():
            return self._advance(s, was, it, eta, delta, value.detach(),
                                 grad.detach())

    def _advance(self, s, was, it, eta, delta, value, grad):
        tol = self.tol
        slope = dot(grad, s["updates"])
        dec = self._decrease_error(eta, value, slope, s["value_init"],
                                   s["slope_init"])
        curv = self._curvature_error(slope, s["slope_init"])
        err = torch.maximum(dec, curv)
        done = err <= tol
        safe_dec = dec <= tol
        last = it + 1 >= self.max_linesearch_steps
        zoom = s["interval_found"]
        new = {}

        # Interval search (Algorithm 3.5).
        keep_safe = {"safe_stepsize": eta, "safe_value": value,
                     "safe_grad": grad}
        search = {k: where(safe_dec, v, s[k]) for k, v in keep_safe.items()}
        set_high = (dec > 0.0) | ((value >= s["value"]) & (it > 0))
        set_low = (slope >= 0.0) & ~set_high
        prev = (s["stepsize"], s["value"], s["slope"])
        cur = (eta, value, slope)
        for i, name in enumerate(("low", "value_low", "slope_low")):
            search[name] = torch.where(set_low, cur[i], prev[i])
        for i, name in enumerate(("high", "value_high", "slope_high")):
            search[name] = torch.where(set_low, prev[i], cur[i])
        search["cubic_ref"] = search["low"]
        search["value_cubic_ref"] = search["value_low"]
        search["interval_found"] = set_high | set_low | done
        search["failed"] = last & ~done

        # Zoom (Algorithm 3.6).
        better = safe_dec & (value < s["safe_value"])
        zoomed = {k: where(better, v, s[k]) for k, v in keep_safe.items()}
        high_to_mid = (dec > 0.0) | (value >= s["value_low"])
        high_to_low = ((slope * (s["high"] - s["low"]) >= 0.0)
                       & ~high_to_mid)
        for i, suffix in enumerate(("", "value_", "slope_")):
            h = torch.where(high_to_mid, cur[i], s[suffix + "high"])
            zoomed[suffix + "high"] = torch.where(high_to_low,
                                                  s[suffix + "low"], h)
            zoomed[suffix + "low"] = torch.where(~high_to_mid, cur[i],
                                                 s[suffix + "low"])
        moved_high = high_to_mid | high_to_low
        zoomed["cubic_ref"] = torch.where(moved_high, s["high"], s["low"])
        zoomed["value_cubic_ref"] = torch.where(moved_high, s["value_high"],
                                                s["value_low"])
        zoomed["interval_found"] = s["interval_found"]
        too_small = delta <= self.interval_threshold
        zoomed["failed"] = (last | (too_small
                                    & (zoomed["safe_stepsize"] > 0.0))) & ~done

        for name in search:
            new[name] = where(zoom, zoomed[name], search[name])
        new.update(count=it + 1, stepsize=eta, value=value, grad=grad,
                   slope=slope, decrease_error=dec, curvature_error=curv,
                   error=err, done=done)
        # _try_safe_step where the search failed.
        fallback = new["failed"] & ((new["safe_stepsize"] > 0.0)
                                    | torch.isinf(dec))
        for name, safe in (("stepsize", "safe_stepsize"),
                           ("value", "safe_value"), ("grad", "safe_grad")):
            new[name] = where(fallback, new[safe], new[name])
        new["active"] = ~(new["done"] | new["failed"])
        for name, t in new.items():
            where(was, t, s[name], out=s[name])
        return was
