"""Fixtures of the benchmark's CPU tests: the benchmark's folder on the
path (its modules import as ``harness``, ``reference``), the ``card``
marker for tests that need a CUDA card, and tiny cells built from the
benchmark's own files with every size cut down."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided here, in the test's
    fixture, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card's machine)")
    return "cuda"


@pytest.fixture
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def steady_clock(monkeypatch):
    """The serving driver's clock advanced 10 ms a reading, so that a
    window holds the same steps however busy the CPU is (a tiny cell's
    sample of finished requests, and so the check, depends on them)."""
    from harness import clock, serve

    t = [clock.now()]

    def tick():
        t[0] += 0.01
        return t[0]

    monkeypatch.setattr(serve, "now", tick)
