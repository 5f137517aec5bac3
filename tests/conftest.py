"""Fixtures shared by the test files."""

import pytest
import torch


@pytest.fixture(scope="session")
def cuda():
    """The card, for the tests marked ``cuda``; they skip on a host without
    one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's card checks)")
    return torch.device("cuda")
