"""The harness of the port's tests: one intra-op torch thread while a test
file runs, and a time limit on each test. A test file takes both by
importing them (autouse fixtures apply to the module that holds them):

    from port_harness import one_torch_thread, time_limit  # noqa: F401
"""

import faulthandler
import os
import signal
import sys
import threading

import pytest
import torch

# Seconds a test may take from this fixture's setup to its teardown: ~3x
# the slowest test of the suite (a 304 s re-exec under six xdist workers
# on an 8-core host). A test's own waits stay below it.
TEST_LIMIT_S = 900.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while the file runs: six workers share
    the cores, and a torch pool of all of them in each slows the eager CPU
    sessions ~18x (measured). MKL_NUM_THREADS=1 sets the count in the
    processes the file's tests start (gloo ranks, peers), where torch reads
    it on import. Restored afterwards. Yields torch's count before."""
    n = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MKL_NUM_THREADS", "1")
        torch.set_num_threads(1)
        yield n
        torch.set_num_threads(n)


def _descendants() -> set:
    """The pids of this process's descendants (Linux /proc)."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except OSError:  # the process has gone
            continue
        children.setdefault(ppid, []).append(int(entry))
    found, todo = set(), [os.getpid()]
    while todo:
        kids = children.get(todo.pop(), [])
        found.update(kids)
        todo.extend(kids)
    return found


def _kill_new(before: set) -> None:
    for pid in _descendants() - before:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


@pytest.fixture(autouse=True)
def time_limit():
    """Fail a test that outlasts TEST_LIMIT_S, and kill the processes it
    started. At the limit faulthandler prints every thread's stack (where
    the test waited) and SIGALRM's handler kills the processes and fails
    the test; it runs in the main thread, which runs the tests, once that
    thread is back in Python. A second later a timer thread kills them
    too, which ends a wait in native code that the handler cannot reach
    before it returns. The run goes on with the next test."""
    limit = TEST_LIMIT_S
    before = _descendants()

    def expire(signum, frame):
        _kill_new(before)
        pytest.fail(f"over its time limit of {limit:g} s", pytrace=False)

    faulthandler.dump_traceback_later(limit, file=sys.stderr)
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    timer = threading.Timer(limit + 1.0, _kill_new, (before,))
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
        faulthandler.cancel_dump_traceback_later()
