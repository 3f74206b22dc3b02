"""The reference figures that phase 10 of chip_smoke.py holds the port's
adaptive arm to (``ADAPTIVE_JAX``): pydens_tpu's examples/09 adaptive fits
on seeds 0-5, recomputed on the CPU by tests/collocation_seed_study.py
from the same configuration that phase 10 reads."""

import numpy as np
import pytest

import chip_smoke as cs
import collocation_seed_study as study


def test_adaptive_reference_figures_are_pydens_tpus():
    values = study.study("jax", "adaptive", list(cs.COLLOCATION_SEEDS))
    # The constants carry four digits.
    assert float(np.median(values)) == pytest.approx(
        cs.ADAPTIVE_JAX["median"], abs=5e-5)
    assert max(values) == pytest.approx(cs.ADAPTIVE_JAX["max"], abs=5e-5)
