"""The benchmark's own tests: on the CPU at small sizes, and (marked
``cuda``) on the card. Run from the repository root:

    python -m pytest benchmark/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips when "
        "torch.cuda.is_available() is False")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the cells at a size the CPU runs in seconds: every width cut, the kind of
# each step kept
SMALL = {"data": {"num_users": 600, "num_items": 300, "num_ratings": 21000},
         "cdae": {"num_dim": 8, "batch_size": 64}}
