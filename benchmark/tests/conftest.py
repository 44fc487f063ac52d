import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture
def card():
    """The CUDA card, decided inside the test: skips where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")
