"""scripts/data_throughput.py at the arguments bench.py's data-pipeline probe
passes: it prints a JSON row with the keys bench.main reads from it."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_data_throughput_prints_the_row_bench_reads():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "data_throughput.py"),
         "--images", "32", "--batches", "3", "--workers", ""],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert rows, proc.stdout[-3000:]
    for key in ("padded_tok_s", "images_s", "host_cores"):
        assert key in rows[0], rows[0]
    assert rows[0]["padded_tok_s"] > 0 and rows[0]["images_s"] > 0
    assert rows[0]["host_cores"] >= 1
