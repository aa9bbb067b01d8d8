"""One intra-op thread for the port's CPU tests.

Each ``tests/test_torch_*.py`` imports ``one_torch_thread``, an autouse
fixture of module scope: its tests, and the module fixtures they use, run
with ``torch.set_num_threads(1)``, and the old count comes back after the
module.  The suite runs under several xdist workers that also start data-
parallel ranks and CLI subprocesses; at the default of one thread a core
each worker's tiny float64 ops (finite-difference gradchecks above all)
spread over every core and the threads of the workers spin against each
other, so that a test of seconds takes minutes.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_a_port_test_module_runs_at_one_thread():
    assert torch.get_num_threads() == 1
