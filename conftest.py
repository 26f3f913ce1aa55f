"""pytest's set-up for the whole repo, beside `tests/conftest.py` (which
puts JAX on the CPU with 8 virtual devices).

Every test runs under a time limit, and the few tests that take minutes
alone are marked slow there (`tests/time_limit.py`).

The port's tests (`tests/test_torch_*.py`) run small shapes on the CPU,
where torch's intra-op threads cost more than they give, and the run's
pytest-xdist workers share the cores: each of those modules runs torch
on one thread. The other modules keep torch's default: with one thread
set, XLA's CPU compiler crashed (SIGSEGV, SIGABRT) where the trainer
compiles in two threads at once (`test_speculative_precompile_threads`).
"""

import pytest

pytest_plugins = ["tests.time_limit"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread(request):
    if not request.module.__name__.rpartition(".")[2].startswith("test_torch_"):
        yield
        return
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
