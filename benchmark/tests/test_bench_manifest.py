"""BENCHMARK.json keeps to the limits of its format (names, units, keys,
sizes, the time a full check of 24 cells takes), and every piece a cell
names is on disk."""

import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.fixture(scope="module")
def man():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    return harness.manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(man["command"]) <= 32 and all(_line(w) for w in man["command"])
    for w in man["command"]:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p.rstrip("/") + "/") for p in man["paths"])
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries(man):
    for group, keys in KEYS.items():
        entries = man[group]
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names)), group
        for e in entries:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, e
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_configs_and_cells(man):
    assert 1 <= len(man["configs"]) <= 24 and 1 <= len(man["workloads"]) <= 24
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    for c in man["configs"]:
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in man["paths"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["source"].startswith("http")
    pairs = {(w["config"], w["traffic"]) for w in man["workloads"]}
    assert len(pairs) == len(man["workloads"])
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)
    for w in man["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        spec = harness.resolve(w["name"])      # config, traffic and limits found by name
        assert set(spec["limits"]["limits"]) and spec["limits"]["control"]


def test_metrics(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(man["per_layer"]) <= 128
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    section = perf[perf.index("## 3. Layers"):perf.index("## 4. Cells")]
    listed = {row.split("|")[1].strip() for row in section.splitlines()
              if row.startswith("| ") and not row.startswith("| Layer")}
    assert {m["layer"] for m in man["per_layer"]} <= listed, listed
    for w in man["workloads"]:
        spec = harness.resolve(w["name"])
        reported = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert spec["per_layer"], w["name"]
        for m in spec["per_layer"]:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in man["per_layer"]:
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in man["workloads"]}
