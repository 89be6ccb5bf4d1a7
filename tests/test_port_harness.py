"""tests/port_harness.py: one intra-op torch thread in the port's test
files and the processes their tests start, and the time limit on each
test."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_harness import one_torch_thread, time_limit  # noqa: F401

TESTS = Path(__file__).resolve().parent

# Two tests that wait on a child process past a 1 s limit, the second in a
# wait that no signal handler reaches until it returns (SIGALRM blocked in
# the thread, as in a wait inside native code), then one that passes: both
# must fail with the stacks printed and their children killed, and the run
# must go on to the third.
_LIMITED = """\
import signal
import subprocess
import sys
from pathlib import Path

import port_harness
from port_harness import time_limit  # noqa: F401

port_harness.TEST_LIMIT_S = 1.0


def wait_on_child(name):
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
    Path(name).write_text(str(child.pid))
    child.wait()


def test_waits_past_the_limit():
    wait_on_child("child.pid")


def test_waits_where_no_handler_runs():
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    try:
        wait_on_child("native_child.pid")
    finally:
        signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGALRM})


def test_after_them():
    pass
"""


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except FileNotFoundError:
        return False


def test_torch_runs_on_one_thread():
    assert torch.get_num_threads() == 1


def test_processes_tests_start_run_torch_on_one_thread():
    """As the gloo mesh ranks and the peers the tests spawn do."""
    run = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                         capture_output=True, text=True, timeout=120, check=True)
    assert run.stdout.strip() == "1", run.stdout + run.stderr


@pytest.mark.parametrize("workers", [[], ["-p", "xdist", "-n", "1"]],
                         ids=["one-process", "xdist-worker"])
def test_time_limit_fails_the_test_and_the_run_goes_on(tmp_path, workers):
    (tmp_path / "test_limited.py").write_text(_LIMITED)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_XDIST", "PYTEST_CURRENT_TEST"))}
    env["PYTHONPATH"] = os.pathsep.join([str(TESTS), str(TESTS.parent)])
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", "-p", "no:randomly",
         *workers, "test_limited.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "2 failed, 1 passed" in out, out
    assert out.count("over its time limit of 1 s") >= 2, out
    # faulthandler's dump: the line each test waited on
    assert out.count("Timeout (0:00:01)!") >= 2, out
    line = _LIMITED.splitlines().index("    child.wait()") + 1
    assert f'test_limited.py", line {line} in wait_on_child' in out, out
    for name in ("child.pid", "native_child.pid"):
        assert not _alive(int((tmp_path / name).read_text())), name
