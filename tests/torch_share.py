"""Each pytest-xdist worker's share of the host's cores for torch on the CPU.

Every ``tests/test_torch_*.py`` file that runs torch imports ``cpu_share``
(``from torch_share import cpu_share  # noqa: F401``): an autouse fixture of
module scope, so it is set up before the module's other fixtures and its
setups run under the share too. Under xdist the workers share the host's
cores: with torch's default of one thread per core in each of 6 workers on
8 cores, beside XLA's own pool, an oversubscribed thread pool slows every
worker many times over (one file took 83.2 s at the default threads and
12.1 s at its share). Outside xdist the share is every thread.

No JAX and nothing of ``monorun_tpu`` here: the card's test files import it
where JAX is not installed. ``tests/test_torch_imports.py`` fails on a port
test file that imports torch without this fixture and is not exempt.
"""

import os

import pytest
import torch


def share(threads: int) -> int:
    """This worker's share of ``threads``: at least one."""
    return max(1, threads // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


@pytest.fixture(scope="module", autouse=True)
def cpu_share():
    threads = torch.get_num_threads()
    torch.set_num_threads(share(threads))
    yield
    torch.set_num_threads(threads)
