"""Shared fixtures of the PyTorch-port tests (``tests/test_torch_*.py``)."""

import pytest
import torch


@pytest.fixture
def cuda_device():
    """A CUDA device, or skip: the card is looked for here, when the test
    runs, never while test modules are imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (hand-written kernels have no CPU "
                    "mode; their plain versions are tested on the CPU)")
    return torch.device("cuda")
