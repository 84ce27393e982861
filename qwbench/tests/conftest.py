import pytest
import torch


@pytest.fixture
def cuda():
    """The card, for tests marked `gpu`; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
