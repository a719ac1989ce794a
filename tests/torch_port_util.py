"""Shared helpers of the paddle_tpu_torch tests (tests/test_torch_*.py)."""
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none.
    Decided inside the fixture, never at import, so every test worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with "
                    "`python -m pytest tests/test_torch_*.py -m cuda`)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread for the module that imports this.
    The suite runs in six worker processes on eight cores, and each
    worker's default pool (a thread per core) oversubscribes the
    machine: a test of many small ops then slows ten times (the fused
    AdamW trajectory of test_torch_fused_optimizer.py: 157 s with the
    default pool in a six-worker run of six port files, 15.5 s with one
    thread; those six files 243 s against 135 s)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
