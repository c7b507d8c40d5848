"""The stage2 step under every scale-out layout against unite_tpu's
one-device step and the port's one-process step, and its checkpoints:
the checks of tests/test_torch_port_scaleout_steps.py (which says what
they hold), on stage2."""

import pytest

from tests.test_torch_port_scaleout_layout import LAYOUTS
from tests.test_torch_port_scaleout_steps import (  # noqa: F401 (fixture)
    cache, check_checkpoint, check_moment_bytes, check_step)

STAGE = "stage2"


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_step_matches_jax_and_one_process(cache, layout):
    check_step(cache, STAGE, layout)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_checkpoint_loads_bit_for_bit(cache, layout):
    check_checkpoint(cache, STAGE, layout)


def test_sharded_moments_take_about_half_a_rank(cache):
    check_moment_bytes(cache, STAGE)
