"""An autouse fixture for the port's CPU tests: one PyTorch intra-op thread.

The suite runs under several pytest-xdist workers on one machine.  Each
PyTorch process defaults to one intra-op thread per core, so the workers
oversubscribe the cores many times over, and the small-tensor loops of the
port (optimizer steps, per-epoch planning) then spend their time waiting on
each other's thread pools: a serve run that takes ~2 s alone took ~390 s
with six such processes side by side on 8 cores.  One thread per test keeps
each worker on one core; the thread count is restored after the test.

Import it into a test module with
``from test_torch_threads import one_torch_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_each_test_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
