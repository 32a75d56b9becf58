"""The readers of the program's own spans and counters
(``recorded.py``), on a recorder filled by calls of each cell at a tiny
size on the CPU: each reads its span or counter over the calls, and
reads nothing from an empty recorder, from a program without the
recorder, or in a cell of the other unit. A metric may list several
cells, each of its own unit."""

from __future__ import annotations

import importlib
import json
import time

import pytest
import torch

from cipbench import run
from ska_sdp_cip_tpu_torch.utils import task_metrics

from .conftest import ROOT, shrink

#: The metrics that read the recorder, with their source.
NAMES = {
    "plan_host_s.image": "program_span",
    "stage_host_s.image": "program_span",
    "work_lists_s.image": "program_span",
    "taper_s.image": "program_span",
    "download_s.image": "program_span",
    "upload_mb.image": "program_counter",
    "gradient_host_s.cycle": "program_span",
    "minor_host_s.cycle": "program_span",
    "taper_s.cycle": "program_span",
    "slot_fill.cycle": "program_counter",
    "register_hit.cycle": "program_counter",
}
PROGRAM = [m for m in json.loads((ROOT / "BENCHMARK.json").read_text())
           ["per_layer"] if m["name"] in NAMES]
CALLS = 2


@pytest.fixture(scope="module")
def filled():
    """Per cell: (a Run of CALLS calls, the recorder's summary after
    them, the cell's readers)."""
    torch.set_num_threads(1)
    out = {}
    for workload in {w for m in PROGRAM for w in m["workloads"]}:
        cell = run.load_cell(ROOT, workload)
        shrink(cell.config)
        driver = importlib.import_module(
            f"cipbench.drivers.{cell.traffic['operation']}")
        state = driver.setup(cell.config, cell.traffic, 3,
                             torch.device("cpu"))
        task_metrics.reset()
        calls = []
        with task_metrics.tracing():
            for _ in range(CALLS):
                t = time.perf_counter()
                state.call()
                calls.append(time.perf_counter() - t)
        state.release()
        state.close()
        out[workload] = (run.Run(unit=driver.UNIT, setup_s=0.0,
                                 window_s=sum(calls), calls=calls,
                                 bounds={}),
                         task_metrics.summary(), cell.readers)
    task_metrics.reset()
    return out


@pytest.fixture
def recorder_of(filled, monkeypatch):
    """Puts a cell's recorded summary back in place of the recorder's."""
    def use(workload):
        monkeypatch.setattr(task_metrics, "summary",
                            lambda: filled[workload][1])
        return filled[workload][0], filled[workload][2]
    return use


def _expected(name: str, summary: dict, calls: int) -> float:
    spans, counters = summary["spans"], summary["counters"]
    if name == "slot_fill.cycle":
        return 100.0 * counters["useful_visits"] / counters["slot_visits"]
    if name == "register_hit.cycle":
        return 100.0 * counters["register_hits"] / counters["register_adds"]
    if name == "upload_mb.image":
        return counters["h2d_bytes"] / 1e6 / calls
    read = {
        "plan_host_s.image": (["plan"], "host_s"),
        "stage_host_s.image": (["stage"], "host_s"),
        "work_lists_s.image": (["invert.work_lists"], "host_s"),
        "taper_s.image": (["invert.taper"], "device_s"),
        "download_s.image": (["download"], "host_s"),
        "gradient_host_s.cycle": (["gradient"], "host_s"),
        "minor_host_s.cycle": (["minor"], "host_s"),
        "taper_s.cycle": (["predict.taper", "invert.taper"], "device_s"),
    }
    names, clock = read[name]
    return sum(spans[n][clock] for n in names) / calls


def test_each_is_declared_in_its_cell():
    assert len(PROGRAM) == len(NAMES)
    for m in PROGRAM:
        assert m["source"] == NAMES[m["name"]]
        unit = m["name"].rsplit(".", 1)[1]
        assert m["workloads"]
        assert len(set(m["workloads"])) == len(m["workloads"])
        for workload in m["workloads"]:
            traffic = run.load_cell(ROOT, workload).traffic
            driver = importlib.import_module(
                f"cipbench.drivers.{traffic['operation']}")
            assert driver.UNIT == unit, (m["name"], workload)
        assert m["moves"] == f"{unit}_s"


@pytest.mark.parametrize("metric", PROGRAM, ids=lambda m: m["name"])
def test_reads_the_recorder(recorder_of, metric):
    for workload in metric["workloads"]:
        run_, readers = recorder_of(workload)
        value = readers[metric["name"]].read(run_)
        summary = task_metrics.summary()
        assert value == pytest.approx(
            _expected(metric["name"], summary, CALLS)), workload
        assert value > 0, workload
        if metric["unit"] == "%":
            assert value <= 100.0, workload
        root = {"image": "image", "cycle": "gradient"}[run_.unit]
        assert summary["spans"][root]["count"] == CALLS, workload


@pytest.mark.parametrize("metric", PROGRAM, ids=lambda m: m["name"])
def test_reads_nothing_without_records(filled, monkeypatch, metric):
    task_metrics.reset()
    for workload in metric["workloads"]:
        run_, _, readers = filled[workload]
        assert readers[metric["name"]].read(run_) is None, workload
    monkeypatch.delattr(task_metrics, "summary")  # a program without it
    for workload in metric["workloads"]:
        run_, _, readers = filled[workload]
        assert readers[metric["name"]].read(run_) is None, workload


@pytest.mark.parametrize("metric", PROGRAM, ids=lambda m: m["name"])
def test_reads_nothing_in_a_cell_of_the_other_unit(recorder_of, filled,
                                                   metric):
    for workload in metric["workloads"]:
        run_, readers = recorder_of(workload)
        others = [w for w, (r, _, _) in filled.items() if r.unit != run_.unit]
        assert others
        for other in others:
            assert readers[metric["name"]].read(filled[other][0]) is None, \
                (workload, other)

