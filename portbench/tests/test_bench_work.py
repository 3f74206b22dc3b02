"""``portbench/work.py``'s counts against hand counts."""

import pytest

from portbench import harness, work

WIDE = harness.config("poisson2d-wide64")
README = harness.config("poisson2d-readme")


def test_forward_counts_by_hand():
    # Sum of fan_in x fan_out: 2*64 + 64*64 + 64*64 + 64*1 = 8,384; the
    # README chain 2*10 + 10*12 + 12*15 + 15*1 = 335.  Five streams: u,
    # u_x, u_y, u_xx, u_yy.
    assert work.products(WIDE) == 8384 and work.products(README) == 335
    assert work.streams(WIDE) == 5
    assert work.taylor_forward(WIDE, 65536)[0] == 65536 * 5 * 8384
    assert work.taylor_forward(README, 100)[0] == 100 * 5 * 335
    assert work.mlp_forward(WIDE, 1048576)[0] == 1048576 * 8384


def test_bytes_and_derived_counts():
    # Weights and biases: 2*64+64 + 2*(64*64+64) + 64+1 = 8,577.
    n, p = 65536, 8577
    assert work.net_params(WIDE) == p
    fwd = 4 * (n * 2 + p + n * 5)
    assert work.taylor_forward(WIDE, n)[1] == fwd
    assert work.taylor_backward(WIDE, n) == (2 * n * 5 * 8384,
                                             fwd + 4 * (p + n * 2))
    assert work.taylor_jvp(WIDE, n) == (3 * n * 5 * 8384,
                                        fwd + 4 * (p + n * 5))
    assert work.mlp_forward(WIDE, 10)[1] == 4 * (10 * 3 + p)
    assert work.adam_step_flops(WIDE, n) == 2 * 3 * n * 5 * 8384
    assert work.lm_step_flops(WIDE, n, 50) == 2 * n * 5 * 8384 * (
        2 + 2 + 50 * 5)
    assert work.predict_flops(WIDE, 7) == 2 * 7 * 8384


def test_bound_is_the_larger_of_the_two_limits():
    assert work.bound_s(67e12, 0) == pytest.approx(2.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
