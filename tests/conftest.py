"""Shared test configuration: CPU-only JAX, deterministic seeds, markers.

The kernels run in Pallas interpret mode off-TPU (the ``ops`` wrappers
default to it), so forcing the CPU platform here gives every test module
the same interpret-mode defaults without per-file boilerplate.
"""

import os

import numpy as np
import pytest

# pin the platform before jax initializes any backend
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (deselect with -m 'not slow')")
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _deterministic_numpy_seed():
    """Reset the legacy numpy global RNG per test for reproducibility."""
    np.random.seed(0)
    yield


@pytest.fixture(autouse=True, scope="module")
def _drop_jit_caches_between_modules():
    """Release compiled executables when a test module finishes.

    The suite compiles hundreds of interpret-mode kernel programs; the jit
    caches keep every executable alive for the whole run, and on the CPU
    backend that accumulation eventually segfaults XLA's backend_compile on
    a later large program (deterministically ~320 tests in).  Per-module
    cache drops bound the live set; within-module caching (the no-retrace
    and single-pack-event tests) is unaffected.
    """
    yield
    jax.clear_caches()
