"""Settings of the benchmark's own tests: the ``card`` marker for tests
that need an NVIDIA card, decided inside a fixture and never at import."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped, with the reason, "
        "where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with "
                    "`python -m pytest -q -m card bench/tests`")
    return torch.device("cuda", 0)
