"""The card fixture of the benchmark's tests."""
from __future__ import annotations

import pytest


@pytest.fixture
def card():
    """Skip without a CUDA card, decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's CUDA kernels)")
    return torch.cuda.get_device_name(0)
