"""Test configuration.

Tests run on the CPU backend with 8 virtual devices (a stand-in for a
multi-card mesh in the sharding tests, per SURVEY.md §4) and float64
enabled so numpy-parity oracles hold to ~1e-12.  This mirrors how the
reference tests "distributed" behaviour in-process with dask's local
scheduler.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; on the card
run them with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``
(a set JAX_PLATFORMS is kept; unset means cpu).

Must run before any jax backend initialization.
"""

import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none (decided
    here, at run time, never while test modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest tests/ -m gpu on the card")
    return jax.devices()[0]
