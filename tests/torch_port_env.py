"""The environment of the port's tests: the machine's cores shared among
the test workers, and the JAX package's native loader built once.

``capped_threads`` is a module-scoped autouse fixture: every
``tests/test_torch_port_*.py`` imports it, and for that file's tests it
caps torch's intra-op threads at one worker's share of the cores,
``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT`` (at least 1), and sets
``OMP_NUM_THREADS`` to the same, so that the processes the tests start
inherit it.  After the file it gives torch its own count and the
environment its own value back, so the JAX package's tests run as they
would without the port's.  Without the cap every worker's torch, and
every child's, starts a thread for each core, and six workers run 48
threads on 8 cores: small operations then wait on each other's thread
pools.

``THREADS`` is the cap, ``DEFAULT_THREADS`` torch's own count.
``default_threads`` is a fixture that gives a test torch's own count
back (a test whose float sums were written against it).
``jax_native_available()`` builds ``native/``'s library under a file
lock: the JAX package builds it with ``make`` at first use, and two
workers building it at once can leave one of them without it.
"""

import fcntl
import os
from pathlib import Path

import pytest
import torch


def _threads() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    return max(1, (os.cpu_count() or 1) // max(1, workers))


DEFAULT_THREADS = torch.get_num_threads()
THREADS = _threads()


@pytest.fixture(scope="module", autouse=True)
def capped_threads():
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    torch.set_num_threads(THREADS)
    try:
        yield THREADS
    finally:
        torch.set_num_threads(DEFAULT_THREADS)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp


@pytest.fixture
def default_threads():
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield DEFAULT_THREADS
    finally:
        torch.set_num_threads(THREADS)


def jax_native_available() -> bool:
    """``uvc_tpu.data.native_loader.available()``, its build serialised
    across processes."""
    from uvc_tpu.data import native_loader
    lock = Path(__file__).resolve().parents[1] / "build" / "native.lock"
    lock.parent.mkdir(exist_ok=True)
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        return native_loader.available()
