"""The learning-rate schedules of pydens_tpu_torch.utils.schedules against
the optax schedules they port, at every count of a range that crosses each
schedule's boundaries, and their use by the optimizers: the schedule is
read at the count before the update, the bias correction at the count
after it."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pydens_tpu_torch.utils import schedules
from pydens_tpu_torch.utils.optimizers import Adam

# (name, args, kwargs): each pair crosses a boundary inside counts 0..N.
CASES = [
    ("constant_schedule", (0.3,), {}),
    ("linear_schedule", (0.1, 0.001, 40), {}),
    ("linear_schedule", (0.1, 0.001, 40), {"transition_begin": 15}),
    ("linear_schedule", (0.1, 0.001, 0), {}),
    ("exponential_decay", (0.1, 10, 0.5), {}),
    ("exponential_decay", (0.1, 10, 0.5), {"staircase": True}),
    ("exponential_decay", (0.1, 7, 0.8),
     {"transition_begin": 12, "staircase": True}),
    ("exponential_decay", (0.1, 5, 0.5), {"end_value": 0.02}),
    ("exponential_decay", (0.01, 5, 1.5), {"end_value": 0.05}),
    ("cosine_decay_schedule", (0.1, 50), {}),
    ("cosine_decay_schedule", (0.1, 50), {"alpha": 0.1, "exponent": 2.0}),
    ("warmup_cosine_decay_schedule", (0.0, 0.1, 10, 60), {}),
    ("warmup_cosine_decay_schedule", (0.01, 0.1, 10, 60),
     {"end_value": 0.001, "exponent": 1.5}),
    ("piecewise_constant_schedule", (0.1, {10: 0.5, 30: 0.1, 31: 2.0}), {}),
    ("piecewise_constant_schedule", (0.1,), {}),
]
N = 80


@pytest.mark.parametrize("name,args,kwargs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_schedule_matches_optax(name, args, kwargs):
    # Counts 0..80 as int32, as optax counts: equal to f32 rounding
    # (rtol 1e-6; the cosine may differ in its last bits).
    port = getattr(schedules, name)(*args, **kwargs)
    ref = getattr(optax, name)(*args, **kwargs)
    for count in range(N + 1):
        out = port(torch.tensor(count, dtype=torch.int32))
        assert out.shape == () and out.dtype == torch.float32
        want = np.float32(ref(jnp.asarray(count, jnp.int32)))
        np.testing.assert_allclose(float(out), want, rtol=1e-6, atol=1e-9,
                                   err_msg=f"count {count}")


def test_schedules_take_float_counts_and_have_no_host_branch():
    # A float count gives the int count's value, and the result is a
    # tensor computed from the count (no Python branch on its value).
    for name, args, kwargs in CASES:
        port = getattr(schedules, name)(*args, **kwargs)
        for count in (0, 9, 10, 11, 47):
            a = port(torch.tensor(count, dtype=torch.int32))
            b = port(torch.tensor(float(count)))
            assert torch.is_tensor(b) and float(a) == float(b)


def test_cosine_rejects_non_positive_decay_steps():
    with pytest.raises(ValueError, match="positive decay_steps"):
        schedules.cosine_decay_schedule(0.1, 0)
    with pytest.raises(ValueError, match="non-negative scale"):
        schedules.piecewise_constant_schedule(0.1, {5: -1.0})


def test_schedule_read_before_the_count_bias_correction_after():
    # A schedule that is 0.1 at count 0 and 0 from count 1 on: the first
    # update moves theta (by about lr, Adam's first step being
    # g / (|g| + eps)), the second does not move it at all, and the
    # bias-corrected moments used count 1 then 2, as optax.adam does.
    sched = schedules.piecewise_constant_schedule(0.1, {1: 0.0})
    opt = Adam(sched)
    theta = torch.tensor([1.0, -2.0, 3.0])
    state = opt.init(theta)
    grads = [torch.tensor([0.5, -1.0, 2.0]), torch.tensor([1.0, 1.0, -1.0])]
    ref = optax.adam(optax.piecewise_constant_schedule(0.1, {1: 0.0}))
    jtheta = jnp.asarray(theta.numpy().copy())
    jstate = ref.init(jtheta)
    after = []
    for g in grads:
        opt.update(theta, g, state)
        upd, jstate = ref.update(jnp.asarray(g.numpy()), jstate, jtheta)
        jtheta = optax.apply_updates(jtheta, upd)
        after.append(theta.clone())
        np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta),
                                   rtol=1e-6)
    np.testing.assert_allclose((after[0] - torch.tensor([1.0, -2.0, 3.0]))
                               .abs().numpy(), 0.1, rtol=1e-5)
    assert torch.equal(after[0], after[1])
    assert int(state["count"]) == 2
    np.testing.assert_allclose(state["nu"].numpy(),
                               np.asarray(jstate[0].nu), rtol=1e-6)
