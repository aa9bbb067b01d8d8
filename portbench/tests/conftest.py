"""Shared set-up of the benchmark's CPU tests: the repository's root on
``sys.path`` and one intra-op thread a test module (the suite may run
under several workers)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small float32 shapes of the cells' configurations, for the CPU: the
# reference's tests at 16x16; the rehearsals at the cells' 64x64 levels
# with narrow channels (enough cells a batch for the fp8 control to read
# past the limits, as it does at full width)
TILE_SMALL = {"model.level_size": 16, "model.base_channels": 16,
              "model.critic_base_channels": 16, "model.group_size": 8,
              "model.dtype": "float32"}
TILE_TINY = {**TILE_SMALL, "model.level_size": 64}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the profiler's device trace)")
    return torch.device("cuda")
