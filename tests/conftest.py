# NOTE: no XLA_FLAGS device-count override here on purpose — smoke tests and
# benches must see the single real CPU device; only launch/dryrun.py forces
# 512 placeholder devices (and only when run as its own main module).
import jax
import pytest

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")
