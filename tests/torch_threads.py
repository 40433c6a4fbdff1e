"""One torch CPU thread for the port's test modules.

The test suite runs in parallel pytest workers (``-n 6``) that share the
machine's cores, and torch's own thread pool then oversubscribes them
while its threads spin-wait: the port's finite-difference tests took
121 s on eight torch threads beside six busy processes on an 8-core
host, and 12 s on one.  Each port test module imports the autouse
fixture below, which holds torch at one thread for that module and
restores the count afterwards.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
