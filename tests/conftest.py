"""Test harness.

Every run but `pytest -m gpu` forces JAX onto the CPU with 8 virtual
devices: sharding and collective code paths are exercised on a virtual
8-device CPU mesh (SURVEY.md §4), and nothing needs a card. Tests that
need one are marked `gpu`, take the `gpu` fixture and skip on the CPU;
`pytest -m gpu` leaves the platform to JAX, so on a machine with a card
they run there (chip_smoke.py runs them in its own process).
"""

import os

import pytest


def pytest_configure(config):
    if config.option.markexpr.strip() == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` or "
                    "`python -m pytest -m gpu tests/` on the card")


@pytest.fixture(scope="session")
def rng():
    import jax
    return jax.random.PRNGKey(0)
