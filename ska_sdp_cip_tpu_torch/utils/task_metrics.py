"""
Per-step task metrics in the reference's pandas-loadable JSON schema.

Counterpart: ``ska_sdp_cip_tpu/utils/task_metrics.py``, copied. The one
difference: :class:`TaskRecorder`'s default ``worker`` names the
process id instead of asking jax for the process index and device.

Each record is a plain dict with the seven columns the reference's
``task-list.json`` carries (``key, worker, status, start, stop, name,
duration`` — reference: src/ska_sdp_cip/task_metrics.py:59-64), so
``pandas.read_json`` analysis written against reference output keeps
working. There is no dask scheduler here: steps of the SPMD program
are timed host-side by :class:`TaskRecorder`. A converter for
task-stream-shaped inputs (per-task ``startstops`` span lists) is
provided for parity with the reference's parser.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Iterator, Union

#: Column order of the exported JSON records.
SCHEMA_KEYS = (
    "key",
    "worker",
    "status",
    "start",
    "stop",
    "name",
    "duration",
)


def task_record(
    key: str, worker: str, status: str, start: float, stop: float
) -> dict:
    """
    One schema record. ``name`` is the key minus its trailing
    ``-<suffix>`` segment (dask-style keys are ``name-hash``);
    ``duration`` spans the whole [start, stop] window.
    """
    return {
        "key": key,
        "worker": worker,
        "status": status,
        "start": start,
        "stop": stop,
        "name": key.rsplit("-", maxsplit=1)[0],
        "duration": stop - start,
    }


def record_from_spans(entry: dict) -> dict:
    """
    Convert a task-stream-shaped dict (``key/worker/status`` plus a
    ``startstops`` list of ``{"action", "start", "stop"}`` spans) into
    a schema record. The record window covers every span, so transfer
    and compute both count toward the duration — the same accounting
    the reference applies to the dask task stream
    (reference: task_metrics.py:67-86).
    """
    spans = entry["startstops"]
    return task_record(
        entry["key"],
        entry["worker"],
        entry["status"],
        min(span["start"] for span in spans),
        max(span["stop"] for span in spans),
    )


def normalize_records(entries: list) -> list:
    """Schema records from a mix of records and task-stream dicts."""
    return [
        entry if "startstops" not in entry else record_from_spans(entry)
        for entry in entries
    ]


def tasks_to_json(records: list, **kwargs) -> str:
    """JSON array of records; kwargs forwarded to ``json.dumps``."""
    return json.dumps(normalize_records(records), **kwargs)


def save_tasks_json(
    records: list, path: Union[str, os.PathLike], **kwargs
) -> None:
    """Write records to ``path`` in the reference schema."""
    with open(path, "w", encoding="utf-8") as file:
        file.write(tasks_to_json(records, **kwargs))


class TaskRecorder:
    """
    Host-side recorder of pipeline steps — the TPU-native replacement
    for wrapping runs in dask's ``get_task_stream()``
    (reference: apps/pipeline_app.py:94-107).

    Use :meth:`step` around each pipeline stage; recorded steps carry
    the executing process/device identity as ``worker`` and export via
    :meth:`save_json`.
    """

    def __init__(self, worker: str | None = None) -> None:
        if worker is None:
            worker = f"process{os.getpid()}"
        self.worker = worker
        self._records: list[dict] = []
        self._counter = 0

    @contextmanager
    def step(self, name: str) -> Iterator[None]:
        """Record one named step; exceptions are recorded then re-raised."""
        key = f"{name}-{self._counter:06d}"
        self._counter += 1
        start = time.time()
        status = "OK"
        try:
            yield
        except Exception:
            status = "error"
            raise
        finally:
            self._records.append(
                task_record(
                    key, self.worker, status, start, time.time()
                )
            )

    @property
    def tasks(self) -> list[dict]:
        """Recorded step records so far."""
        return list(self._records)

    def save_json(
        self, path: Union[str, os.PathLike], **kwargs
    ) -> None:
        """Export recorded steps to ``path`` in the reference schema."""
        save_tasks_json(self._records, path, **kwargs)
