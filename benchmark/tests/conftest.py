"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
root of the repo. Tests marked `cuda` need a CUDA device and skip without
one; on the card: `python -m pytest benchmark/tests -m cuda -q`."""

import os
import sys

import pytest

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_BENCH, os.path.dirname(_BENCH)]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
