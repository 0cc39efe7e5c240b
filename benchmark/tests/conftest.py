"""The benchmark's own tests. `card` marks a test that needs a CUDA card;
whether there is one is decided inside the `card` fixture, never while a
module is imported, so every worker collects the same tests. On the card:
`python3 -m pytest benchmark/tests -m card`."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with python3 -m pytest benchmark/tests -m card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
