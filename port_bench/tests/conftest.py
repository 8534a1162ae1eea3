"""CPU tests of the benchmark harness. The card is decided inside a
fixture (`card`), never while a module is imported."""

import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.cuda.get_device_name(0)
