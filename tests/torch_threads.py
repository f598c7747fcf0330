"""One intra-op torch thread for a port test module's in-process work.

A module imports the fixture (``from torch_threads import
one_torch_thread``); being autouse and module-scoped, it holds torch at one
thread from the module's first fixture to its last test and then restores
the count. The suite runs in parallel pytest-xdist workers that share the
machine's cores; with torch's default of a thread a core, every small op's
OpenMP barrier waits for cores the other workers hold. Six of these
modules run side by side (``-n 6 --dist loadfile``) took 481 s on the
default and 233 s on one thread, and one inline-loop test of
``test_torch_scheduler.py`` took 1398 s beside five workers against 17 s
alone. Child processes set ``OMP_NUM_THREADS`` themselves.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
