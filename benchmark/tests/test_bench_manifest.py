"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import os
import re

from benchmark.tests.micro import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert not any(w.startswith("/") for w in b["command"])
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
        names.append(w["name"])
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                       ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in b[kind]:
            assert set(m) - {"workloads"} == keys, m
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            names.append(m["name"])
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) < 64 * 1024


def test_bounds_and_run_seconds():
    b = bench()
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in b["end_to_end"])
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def reports(m, cell):
    return cell in m.get("workloads", [cell])


def test_every_cell_reports_enough_and_each_metric_its_moves():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        mine = [m for m in b["end_to_end"] if reports(m, w["name"])]
        assert any(m["name"] == "setup_s" for m in mine) and len(mine) >= 2
        assert any(reports(m, w["name"]) for m in b["per_layer"])
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", [w["name"] for w in b["workloads"]]):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
        assert line(m["layer"])
        layers.setdefault(m["name"].split(".")[-1], set()).add(m["layer"])
    assert sum(1 for w in b["workloads"] if w["chips"] == 4) <= max(1, len(b["workloads"]) // 4)


def test_files_each_name_finds():
    b = bench()
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        with open(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json")) as f:
            mix = json.load(f)
        for d in ("traffic", "sessions"):
            assert os.path.isfile(os.path.join(ROOT, "benchmark", d, mix["kind"] + ".py"))
        with open(os.path.join(ROOT, "benchmark", "workloads", w["name"] + ".json")) as f:
            assert json.load(f)["limits"]
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))


def test_configs_keep_every_width():
    """The full configuration is BagelConfig() as the port defines it, and
    the cut one differs from it only in what it lists in `reduced`."""
    from benchmark.harness.program import bagel_config
    from bagel_tpu_torch.configs import BagelConfig
    import dataclasses

    b = bench()
    full = dataclasses.asdict(BagelConfig())
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            got = dataclasses.asdict(bagel_config(json.load(f)["model"]))
        for group in ("llm", "vit", "vae"):
            for k, v in full[group].items():
                if k not in c["reduced"]:
                    assert got[group][k] == v, (c["name"], group, k)
