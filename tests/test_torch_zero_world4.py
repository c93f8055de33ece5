"""The engine's data-parallel training at ZeRO stages 0-3 over a gloo gang
of 4 ranks against the JAX engine on a 4-device sub-mesh (the checks of
``tests/test_torch_zero.py``, which runs 2 ranks; split so the test runner
can spread the two)."""

import pytest

from tests.test_torch_zero import check_engine_against_jax, make_jax_runs
from tests.torch_gang import Gang


@pytest.fixture(scope="module")
def gang():
    g = Gang(4)
    yield g
    g.close()


@pytest.fixture(scope="module")
def jax_runs():
    return make_jax_runs()


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_engine_matches_the_jax_engine_on_a_4_device_sub_mesh(gang, jax_runs, stage):
    """Three ``train_batch`` steps at ZeRO ``stage`` over 4 ranks, held as
    ``test_engine_matches_the_jax_engine_on_a_sub_mesh`` holds 2."""
    check_engine_against_jax(gang, jax_runs, 4, stage)
