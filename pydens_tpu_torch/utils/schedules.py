"""Learning-rate schedules, the port's counterparts of the optax schedules
that ``pydens_tpu``'s users pass as ``fit(lr=...)``.

Each constructor takes optax 0.2.6's arguments and returns a function of a
0-d step-count tensor (integer or float, on the device) that returns a 0-d
float32 tensor.  The function is torch ops only, with no Python branch on
the count and no host read, so it runs inside a captured CUDA graph of the
fit step.  The count is the number of updates already applied: an
optimizer evaluates the schedule before it counts the current update, as
``optax.scale_by_schedule`` does (the first update uses ``schedule(0)``).
"""

import math

import torch

__all__ = ["constant_schedule", "linear_schedule", "exponential_decay",
           "cosine_decay_schedule", "warmup_cosine_decay_schedule",
           "piecewise_constant_schedule"]


def _count(count):
    """The count in float32: exact for every count below 2**24."""
    return torch.as_tensor(count).to(torch.float32)


def constant_schedule(value):
    """``value`` at every count."""
    def schedule(count):
        return torch.full((), float(value), dtype=torch.float32,
                          device=torch.as_tensor(count).device)
    return schedule


def linear_schedule(init_value, end_value, transition_steps,
                    transition_begin=0):
    """``init_value`` until ``transition_begin``, then linear to
    ``end_value`` over ``transition_steps`` counts, then ``end_value``.
    ``transition_steps <= 0`` holds ``init_value``; a negative
    ``transition_begin`` counts as 0."""
    if transition_steps <= 0:
        return constant_schedule(init_value)
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        c = torch.clamp(_count(count) - transition_begin, 0, transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def exponential_decay(init_value, transition_steps, decay_rate,
                      transition_begin=0, staircase=False, end_value=None):
    """``init_value * decay_rate ** ((count - transition_begin) /
    transition_steps)`` from ``transition_begin`` on (the exponent floored
    with ``staircase``), ``init_value`` before it; ``end_value`` bounds it
    from below when ``decay_rate < 1``, from above otherwise."""
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        decreased = _count(count) - transition_begin
        p = decreased / transition_steps
        if staircase:
            p = torch.floor(p)
        value = torch.where(decreased <= 0, init_value,
                            init_value * torch.pow(decay_rate, p))
        if end_value is not None:
            value = (torch.clamp(value, min=end_value) if decay_rate < 1.0
                     else torch.clamp(value, max=end_value))
        return value
    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0, exponent=1.0):
    """``init_value * ((1 - alpha) * (0.5 * (1 + cos(pi * t / T))) **
    exponent + alpha)`` with ``t = min(count, decay_steps)``."""
    if not decay_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay_steps!r}.")
    decay_steps = float(decay_steps)

    def schedule(count):
        c = torch.clamp(_count(count), max=decay_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps, end_value=0.0, exponent=1.0):
    """Linear from ``init_value`` to ``peak_value`` over ``warmup_steps``,
    then a cosine decay to ``end_value`` at ``decay_steps`` (which includes
    the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha=alpha, exponent=exponent)

    def schedule(count):
        c = _count(count)
        return torch.where(c < warmup_steps, warmup(c),
                           decay(c - warmup_steps))
    return schedule


def piecewise_constant_schedule(init_value, boundaries_and_scales=None):
    """``init_value`` times every ``scale`` of ``{boundary: scale}`` whose
    boundary the count has reached."""
    if boundaries_and_scales is not None and not all(
            scale >= 0.0 for scale in boundaries_and_scales.values()):
        raise ValueError(
            "`piecewise_constant_schedule` expects non-negative scale factors")
    steps = sorted((boundaries_and_scales or {}).items())

    def schedule(count):
        c = _count(count)
        v = torch.full((), float(init_value), dtype=torch.float32,
                       device=c.device)
        for threshold, scale in steps:
            indicator = torch.clamp(torch.sign(threshold - c), min=0.0)
            v = v * indicator + (1 - indicator) * scale * v
        return v
    return schedule
