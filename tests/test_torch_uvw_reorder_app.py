"""
The port's reorder CLI (``tpu-cip-reorder-uvw-torch``,
``apps/uvw_reorder_app.py``) and task metrics (``utils/task_metrics.py``)
on the CPU: port versions of ``tests/test_uvw_reorder_app.py`` and
``tests/test_task_metrics.py``.

* the CLI takes ``tpu-cip-reorder-uvw``'s arguments, writes the JAX
  CLI's tiles and ``task-list.json``; its multi-host path (two hosts in
  two threads, pass 1, the marker-file barrier, pass 2) writes the
  single-host run's files;
* the task records and their JSON export keep the reference's schema.
"""

import json
import threading

import pytest

from ska_sdp_cip_tpu.apps import uvw_reorder_app as japp
from ska_sdp_cip_tpu_torch.apps.uvw_reorder_app import (
    get_parser,
    resolve_run_id,
    run_program,
)
from ska_sdp_cip_tpu_torch.utils.task_metrics import (
    SCHEMA_KEYS,
    TaskRecorder,
    record_from_spans,
    save_tasks_json,
    task_record,
    tasks_to_json,
)


def _argv(dataset, outdir, *extra):
    return [str(dataset), "-t", "3000", "3000", "6000", "-o", str(outdir),
            "-n", "2", "-m", "10000", "-j", "2", *extra]


def _options(parser):
    return {a.dest: (a.option_strings, a.default, a.nargs, a.type)
            for a in parser._actions if a.dest != "help"}


def test_arguments_are_the_jax_cli_arguments():
    assert _options(get_parser()) == _options(japp.get_parser())


def test_reorder_cli(dataset_path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    outdir = tmp_path / "tiles"
    run_program(_argv(dataset_path, outdir))
    chunks = sorted(p.name for p in outdir.glob("tile_iu*chunk*.npz"))
    assert chunks
    tasks = json.loads((tmp_path / "task-list.json").read_text())
    assert tasks[0]["name"] == "reorder_by_uvw_tile"
    assert list(tasks[0]) == sorted(SCHEMA_KEYS)
    japp.run_program(_argv(dataset_path, tmp_path / "jax_tiles"))
    assert chunks == sorted(
        p.name for p in (tmp_path / "jax_tiles").glob("tile_iu*chunk*.npz")
    )


def test_multihost_cli_barrier(dataset_path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    outdir = tmp_path / "tiles"
    errors = []

    def host(index):
        try:
            run_program(_argv(dataset_path, outdir, "--num-hosts", "2",
                              "--host-index", str(index), "--run-id", "t1"))
        except Exception as err:  # reported by the assertion below
            errors.append(err)

    threads = [threading.Thread(target=host, args=(i,)) for i in range(2)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=240)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(list(outdir.glob("host*.pass1.t1.done"))) == 2
    names = [t["name"] for t in json.loads(
        (tmp_path / "task-list.json").read_text())]
    assert names == ["reorder_pass1", "pass1_barrier", "reorder_pass2"]
    run_program(_argv(dataset_path, tmp_path / "single"))
    assert sorted(p.name for p in outdir.glob("tile_iu*chunk*.npz")) == sorted(
        p.name for p in (tmp_path / "single").glob("tile_iu*chunk*.npz"))


def test_resolve_run_id(monkeypatch):
    """Multi-host runs never fall back to a colliding constant id."""
    monkeypatch.delenv("CIP_RUN_ID", raising=False)
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    assert resolve_run_id("abc", 4) == "abc"
    assert resolve_run_id(None, 1) == "run"
    with pytest.raises(SystemExit, match="run-id"):
        resolve_run_id(None, 2)
    monkeypatch.setenv("SLURM_JOB_ID", "123456")
    assert resolve_run_id(None, 2) == "123456"
    monkeypatch.setenv("CIP_RUN_ID", "launch-7")
    assert resolve_run_id(None, 2) == "launch-7"


TASK_STREAM_DATA = [
    {
        "key": "load_chunk-abc123",
        "worker": "tcp://127.0.0.1:40000",
        "status": "OK",
        "startstops": (
            {"action": "compute", "start": 100.0, "stop": 103.0},
        ),
    },
    {
        "key": "grid_chunk-def456",
        "worker": "tcp://127.0.0.1:40001",
        "status": "OK",
        "startstops": (
            {"action": "transfer", "start": 104.0, "stop": 105.0},
            {"action": "compute", "start": 105.5, "stop": 110.0},
        ),
    },
]


def test_record_from_spans_duration_covers_transfer_and_compute():
    record = record_from_spans(TASK_STREAM_DATA[1])
    assert record["start"] == 104.0
    assert record["stop"] == 110.0
    assert record["duration"] == 6.0
    assert record["name"] == "grid_chunk"
    assert record["worker"] == "tcp://127.0.0.1:40001"


def test_record_name_strips_trailing_hash():
    record = task_record("a-b-c-123abc", "w", "OK", 0.0, 1.0)
    assert record["name"] == "a-b-c"


def test_tasks_to_json_schema():
    data = json.loads(tasks_to_json(TASK_STREAM_DATA))
    assert len(data) == 2
    assert data[0] == {
        "key": "load_chunk-abc123",
        "worker": "tcp://127.0.0.1:40000",
        "status": "OK",
        "start": 100.0,
        "stop": 103.0,
        "name": "load_chunk",
        "duration": 3.0,
    }


def test_save_tasks_json_pandas_loadable(tmp_path):
    import pandas as pd

    path = tmp_path / "task-list.json"
    save_tasks_json(TASK_STREAM_DATA, path)
    frame = pd.read_json(path)
    assert list(frame.columns) == list(SCHEMA_KEYS)
    assert len(frame) == 2


def test_task_recorder_records_steps(tmp_path):
    recorder = TaskRecorder(worker="test-worker")
    with recorder.step("load"):
        pass
    with recorder.step("grid"):
        pass
    with pytest.raises(RuntimeError):
        with recorder.step("boom"):
            raise RuntimeError("expected")

    tasks = recorder.tasks
    assert [t["name"] for t in tasks] == ["load", "grid", "boom"]
    assert [t["status"] for t in tasks] == ["OK", "OK", "error"]
    assert all(t["worker"] == "test-worker" for t in tasks)
    assert all(t["duration"] >= 0 for t in tasks)

    path = tmp_path / "task-list.json"
    recorder.save_json(path)
    assert len(json.loads(path.read_text())) == 3
    assert TaskRecorder().worker.startswith("process")
