"""The port's test files run their torch ops on one CPU thread.

Each ``tests/test_torch_*.py`` imports :func:`one_torch_thread`, an
autouse module-scoped fixture: torch's intra-op thread count is 1 while
the module's tests run and goes back to what it was after them, so the
JAX package's tests in the same worker are untouched. The port's tests
run tiny tensors, where a thread pool of one thread a core costs more
than the op: in an 8-core CPU container a [64, 96] @ [96, 64] matmul took
6.6 ms on torch's default 8 threads and 0.015 ms on 1 to 4 (torch
2.13 for the CPU). The tests compare the same values either way.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
