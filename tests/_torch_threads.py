"""One intra-op thread for a port test module.

The port's CPU tests run the smoke configs' many small ops, which run no
faster on more threads; under pytest-xdist every worker would otherwise
start torch's default of one thread a core, oversubscribing the machine's
cores several times over, and a test that steps an engine thousands of
times then runs tens of times slower than alone. A test module takes the
fixture by importing it::

    from _torch_threads import one_thread  # noqa: F401
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch at one intra-op thread while the module's tests run, the
    thread count it had restored after them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
