"""What every test of the port runs under, without pytest-timeout.

Each tests/test_torch_*.py imports the autouse fixture `port_limits`
(tests/test_torch_test_env.py checks that every one does). From the test's
own set-up on (module-scoped fixtures are built before it), it gives:

- a time limit: a test still running LIMIT_S seconds later fails where
  it stands, with the stacks of every thread in its report, and the run
  goes on. The alarm is SIGALRM, so it needs the main thread, where
  pytest-xdist's workers run their tests. A test that spawns processes
  kills them on its way out (`reaped` below).
- under pytest-xdist, the worker's share of the host's cores for torch's
  intra-op threads: six workers of eight threads on eight cores wait on
  one another at every parallel region (on an 8-core host, a one-process
  run of the port's train driver took 2.9 s alone, 28 s in the suite).
  The worker's own count is put back after the test. XLA's threads are
  left as they are: they set the JAX references' reduction order.
"""

import contextlib
import os
import signal
import sys
import threading
import traceback

import pytest
import torch

# about 1.7 times the slowest test of a tier-1 run
LIMIT_S = 420.0


def _stacks() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    return "\n".join(f"--- thread {names.get(ident, ident)} ---\n" + "".join(
        traceback.format_stack(frame)) for ident, frame in sys._current_frames().items())


@pytest.fixture(autouse=True)
def port_limits(request):
    threads = torch.get_num_threads()
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, os.cpu_count() // int(workers)))
    timed = threading.current_thread() is threading.main_thread()
    if timed:
        limit = LIMIT_S

        def expire(signum, frame):
            pytest.fail(f"{request.node.nodeid} ran past its time limit of {limit:g} s\n"
                        f"{_stacks()}")

        previous = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        if timed:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)
        torch.set_num_threads(threads)


@contextlib.contextmanager
def reaped(procs):
    """Kill whichever of `procs` (subprocess.Popen) still runs when the
    block leaves, whatever ends it: a deadline, a failed check, the time
    limit. Nothing a test started outlives it."""
    try:
        yield procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
