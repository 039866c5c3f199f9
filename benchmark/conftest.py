"""pytest settings of the benchmark's own tests (`benchmark/tests/`).

The `card` marker names a test that needs an NVIDIA card; the `card`
fixture skips it where there is none. Whether there is a card is decided
in the fixture, never while a module is imported.
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(BENCH), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
