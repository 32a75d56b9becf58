"""The reader of B1's register share (``register_hit.cycle``): the
program's counters ``register_hits`` over ``register_adds`` in a cycle
run, and nothing outside a cycle run, from a recorder without the
counters, or from a program without the recorder."""

from __future__ import annotations

import pytest

from cipbench import run
from ska_sdp_cip_tpu_torch.utils import task_metrics

from .conftest import ROOT

NAME = "register_hit.cycle"


@pytest.fixture
def reader():
    return run.load_module(ROOT / "cipbench" / "metrics" / f"{NAME}.py")


def _run(unit: str) -> run.Run:
    return run.Run(unit=unit, setup_s=0.0, window_s=1.0, calls=[1.0],
                   bounds={})


def _recorded(monkeypatch, counters: dict) -> None:
    monkeypatch.setattr(task_metrics, "summary",
                        lambda: {"spans": {"gradient": {"count": 1}},
                                 "counters": counters})


def test_is_declared_in_the_cycle_cell():
    cell = run.load_cell(ROOT, "csd3-10k.cycle")
    (metric,) = [m for m in cell.per_layer if m["name"] == NAME]
    assert metric["workloads"] == ["csd3-10k.cycle"]
    assert metric["source"] == "program_counter"
    assert metric["moves"] == "cycle_s" and metric["unit"] == "%"
    assert NAME in cell.readers


@pytest.mark.parametrize("hits", [0, 4_100, 6_400])
def test_reads_the_counters(reader, monkeypatch, hits):
    _recorded(monkeypatch, {"register_hits": hits, "register_adds": 6_400,
                            "useful_visits": 7})
    assert reader.read(_run("cycle")) == pytest.approx(100.0 * hits / 6_400)


@pytest.mark.parametrize("counters", [
    {}, {"useful_visits": 7, "slot_visits": 9}, {"register_hits": 3},
    {"register_adds": 64}, {"register_hits": 0, "register_adds": 0}])
def test_reads_nothing_without_the_counters(reader, monkeypatch, counters):
    _recorded(monkeypatch, counters)
    assert reader.read(_run("cycle")) is None


def test_reads_nothing_without_records_or_the_recorder(reader, monkeypatch):
    task_metrics.reset()
    assert reader.read(_run("cycle")) is None
    monkeypatch.delattr(task_metrics, "summary")  # a program without it
    assert reader.read(_run("cycle")) is None


def test_reads_nothing_outside_a_cycle_run(reader, monkeypatch):
    _recorded(monkeypatch, {"register_hits": 50, "register_adds": 64})
    assert reader.read(_run("image")) is None
