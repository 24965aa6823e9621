"""A fixture for the port's longer CPU tests.

The suite runs in several test processes at once. Each PyTorch process
starts an OpenMP pool as wide as the machine, and those pools, spinning
while they wait, oversubscribe the cores: the loop tests then run many
times slower than alone. One intra-op thread per process avoids that.
Import ``one_torch_thread`` into a test module to apply it there."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_module_with_the_fixture_runs_on_one_thread():
    assert torch.get_num_threads() == 1
