"""The readers of the sharded cell's own spans and counters
(``sharded_residual_s.cycle``, ``collective_s.cycle``,
``collective_roofline.cycle``) on a recorder filled by calls of
``csd3-10k-4node.sharded4`` at a tiny size on the CPU, in a world of one
process holding the four shards, where the psum's span is a host span:
each reads its span or counter over the calls, and reads nothing from an
empty recorder, from a program without the recorder, or in a run of the
other unit. A call opens the step's span ``sharded.step`` once."""

from __future__ import annotations

import importlib
import json
import time

import pytest
import torch

from cipbench import run, work_sharded
from ska_sdp_cip_tpu_torch.utils import task_metrics

from .conftest import ROOT, shrink

CELL = "csd3-10k-4node.sharded4"
#: The sharded cell's own readers, with their source.
NAMES = {
    "sharded_residual_s.cycle": "program_span",
    "collective_s.cycle": "program_span",
    "collective_roofline.cycle": "program_span",
}
CALLS = 2


@pytest.fixture(scope="module")
def filled():
    """(a Run of CALLS calls of the cell, the recorder's summary after
    them, the cell's readers)."""
    torch.set_num_threads(1)
    cell = run.load_cell(ROOT, CELL)
    shrink(cell.config)
    driver = importlib.import_module(
        f"cipbench.drivers.{cell.traffic['operation']}")
    state = driver.setup(cell.config, cell.traffic, 3, torch.device("cpu"))
    task_metrics.reset()
    calls = []
    with task_metrics.tracing():
        for _ in range(CALLS):
            t = time.perf_counter()
            state.call()
            calls.append(time.perf_counter() - t)
    state.release()
    state.close()
    summary = task_metrics.summary()
    task_metrics.reset()
    return (run.Run(unit=driver.UNIT, setup_s=0.0, window_s=sum(calls),
                    calls=calls, bounds={}),
            summary, cell.readers)


@pytest.fixture
def recorded(filled, monkeypatch):
    """Puts the cell's recorded summary back in place of the
    recorder's."""
    monkeypatch.setattr(task_metrics, "summary", lambda: filled[1])
    return filled


def _expected(name: str, summary: dict, calls: int) -> float:
    spans, counters = summary["spans"], summary["counters"]
    if name == "sharded_residual_s.cycle":
        return spans["sharded.residual"]["device_s"] / calls
    psum = spans["collective.all_reduce"]["host_s"]   # a CPU mesh's
    if name == "collective_s.cycle":
        return psum / calls
    return 100.0 * work_sharded.psum_least_seconds(
        counters["collective.all_reduce.bytes"]) / psum


def test_each_is_declared_for_the_cell_alone():
    declared = {m["name"]: m for m in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["per_layer"]
        if m["name"] in NAMES}
    assert set(declared) == set(NAMES)
    for name, m in declared.items():
        assert m["source"] == NAMES[name]
        assert m["workloads"] == [CELL]
        assert m["moves"] == "cycle_s"


@pytest.mark.parametrize("name", sorted(NAMES))
def test_reads_the_recorder(recorded, name):
    run_, summary, readers = recorded
    value = readers[name].read(run_)
    assert value == pytest.approx(_expected(name, summary, CALLS))
    assert value > 0
    if name.split(".")[0].endswith("roofline"):
        assert value <= 100.0
    assert summary["spans"]["sharded.step"]["count"] == CALLS
    assert summary["spans"]["sharded.residual"]["count"] == CALLS
    assert summary["counters"]["collective.all_reduce.calls"] == CALLS


@pytest.mark.parametrize("name", sorted(NAMES))
def test_reads_nothing_without_records(filled, monkeypatch, name):
    run_, _, readers = filled
    task_metrics.reset()
    assert readers[name].read(run_) is None
    monkeypatch.delattr(task_metrics, "summary")  # a program without it
    assert readers[name].read(run_) is None


@pytest.mark.parametrize("name", sorted(NAMES))
def test_reads_nothing_in_a_run_of_the_other_unit(recorded, name):
    run_, _, readers = recorded
    other = run.Run(unit="image", setup_s=0.0, window_s=run_.window_s,
                    calls=run_.calls, bounds={})
    assert readers[name].read(other) is None
