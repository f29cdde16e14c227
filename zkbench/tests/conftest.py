"""CPU tests of the benchmark harness: ``python -m pytest zkbench/tests``.

Tests marked ``chip`` need a CUDA card; each decides inside the ``card``
fixture, never at import, and skips here with the reason.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (run on the card with python -m pytest -m chip zkbench/tests)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)
