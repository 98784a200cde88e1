"""pytest settings of the benchmark's own tests: the ``gpu`` marker (a
test that needs a CUDA card; it skips without one, decided in a fixture)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
