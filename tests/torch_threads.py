"""One intra-op thread for a test module of the PyTorch port.

The port's CPU frames, substeps and kernel twins are many small ATen ops.
Under the suite's parallel run (pytest-xdist, a worker a core) each
worker's default pool, a thread a core, oversubscribes the cores, and such
a module ran about ten times slower than alone. A module takes the fixture
by importing it:

    from torch_threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's tests run the port on one intra-op thread; the count
    is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
