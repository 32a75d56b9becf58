"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its files."""

from __future__ import annotations

import json
import re

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    every = [x["name"] for k in ("configs", "workloads") for x in BENCH[k]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(every)) == len(every)
    assert len(set(metrics)) == len(metrics)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def _applies(m, cell):
    return "workloads" not in m or cell in m["workloads"]


def test_every_cell_reports_enough_and_finds_its_files():
    here = ROOT / "cipbench"
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"] if _applies(m, w["name"])]
        layer = [m for m in BENCH["per_layer"] if _applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert layer
        for m in layer:      # the metric each moves is reported there
            assert _applies(e2e[m["moves"]], w["name"])
        traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (here / "drivers" / f"{traffic['operation']}.py").is_file()
        assert (here / "limits" / f"{w['name']}.json").is_file()
        for m in mine + layer:
            assert (here / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_layers_spelled_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        stem = m["name"].split(".")[0]
        layers.setdefault(stem, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
