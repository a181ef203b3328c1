"""tests/torch_test_env.py: a test that runs past its limit fails, the run
goes on to the next test, an xdist worker's torch takes its share of the
cores, and every test file of the port takes the fixture."""

import ast
import glob
import os
import subprocess
import sys
import time

import pytest

from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

TESTS = os.path.dirname(os.path.abspath(__file__))

STUCK = """
import os
import time

import torch

from torch_test_env import port_limits  # noqa: F401


def test_sleeps():
    time.sleep(60)


def test_after():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        assert torch.get_num_threads() == max(1, os.cpu_count() // int(workers))
"""


@pytest.mark.parametrize("xdist", [[], ["-p", "xdist", "-n", "2"]], ids=["plain", "xdist"])
def test_a_stuck_test_fails_at_its_limit_and_the_run_goes_on(tmp_path, xdist):
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "conftest.py").write_text("import torch_test_env\n\ntorch_test_env.LIMIT_S = 2\n")
    (tmp_path / "test_stuck.py").write_text(STUCK)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = TESTS + os.pathsep + env.get("PYTHONPATH", "")
    start = time.monotonic()
    run = subprocess.run([sys.executable, "-m", "pytest", "-p", "no:cacheprovider", *xdist],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert time.monotonic() - start < 60, run.stdout
    assert run.returncode == 1, run.stdout + run.stderr
    assert "1 failed, 1 passed" in run.stdout, run.stdout
    assert "test_sleeps ran past its time limit of 2 s" in run.stdout, run.stdout
    assert "--- thread MainThread ---" in run.stdout, run.stdout


def test_every_port_test_file_takes_the_limits():
    def takes(path):
        tree = ast.parse(open(path).read())
        return any(isinstance(node, ast.ImportFrom) and node.module == "torch_test_env"
                   and "port_limits" in [a.name for a in node.names] for node in tree.body)

    files = sorted(glob.glob(os.path.join(TESTS, "test_torch_*.py")))
    assert len(files) > 40
    assert [os.path.basename(f) for f in files if not takes(f)] == []
