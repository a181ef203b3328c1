"""A whole run through `benchmark/run.py`'s main, without the look for a
card, on the CPU at a micro size: the result line's keys, each cell's
metrics by name, and the compared numbers last."""

import json

import pytest

from benchmark import run as bench_run
from benchmark.tests.micro import bench, make_run


@pytest.mark.parametrize("kind,workload", [("t2i_closed", "bagel-7b-mot.t2i-1024"),
                                           ("chat_closed", "bagel-7b-mot.chat-mix-8")])
def test_main_prints_the_result_line(kind, workload, monkeypatch, capsys):
    micro = make_run(kind)
    load = bench_run.load_json

    def load_json(*parts):
        return micro.config if parts[:2] == ("benchmark", "configs") else load(*parts)

    monkeypatch.setattr(bench_run, "load_json", load_json)
    monkeypatch.setattr(bench_run, "load_cell", lambda b, w: dict(
        micro.cell, name=w, config="micro"))
    res = bench_run.main(["--workload", workload, "--seed", str(2**31 + 5), "--seconds", "0.3"],
                         need_card=False, device=micro.device)
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"] is True
    want = {m["name"] for m in bench()["end_to_end"] if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == want
    assert out.err.strip().splitlines()[-1].startswith("check failed_requests")
