"""Test environment: an 8-device virtual CPU platform, unless on the card.

Tests run on a virtual 8-device CPU mesh (SURVEY.md section 4), so sharding
and collective paths are exercised without accelerators; Pallas kernels run
in interpret mode. Tests that need the GPU carry the ``gpu`` marker and skip
inside the ``gpu`` fixture when JAX's backend is not ``gpu``.
``chip_smoke.py`` runs them on the card in its own process, with
``TRACER_TESTS_ON_GPU=1`` so this file leaves the platform alone.
"""

import os

ON_GPU = os.environ.get("TRACER_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs the GPU; run on the card by chip_smoke.py")


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is the GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: Triton kernels compile only for the card")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound backend memory growth across the run.

    The full suite compiles hundreds of distinct programs (many with large
    constant operands); dropping the compilation cache between modules
    keeps the process bounded, and per-module locality keeps the
    re-compile cost negligible (modules rarely share jit signatures).
    """
    yield
    jax.clear_caches()
