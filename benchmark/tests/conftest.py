"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.
Tests that need a CUDA device carry the ``cuda`` marker and skip without
one; on the card: ``python3 -m pytest benchmark/tests -q -m cuda``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device; skips elsewhere")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
