"""The benchmark's tests run with one torch thread: several test processes
share the cores."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
