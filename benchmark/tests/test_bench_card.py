"""On the card: the control at the cells' own size, three seeds each
(`benchmark/tools/readings.py`); each must fail the cell's limits. Skips
without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.micro import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["bagel-7b-mot.t2i-1024", "bagel-7b-mot.chat-mix-8"])
def test_control_fails_at_the_cell_size(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "tools", "readings.py"),
                          "--workload", workload, "--seeds", "101,102,103", "--control", "w8a8"],
                         capture_output=True, text=True, timeout=1800, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(os.path.join(ROOT, "benchmark", "workloads", workload + ".json")) as f:
        limits = json.load(f)["limits"]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 3
    for ln in lines:
        assert any(ln["readings"][n] > lim for n, lim in limits.items()), ln
