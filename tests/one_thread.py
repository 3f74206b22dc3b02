"""One intra-op torch thread for a test module's small shapes: as fast
there, and it leaves the other cores to the suite's other workers (each
worker's torch would take a thread for every core).  A module imports the
fixture to use it: ``from one_thread import one_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
