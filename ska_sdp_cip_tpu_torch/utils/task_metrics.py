"""
Per-step task metrics in the reference's pandas-loadable JSON schema,
and the program's own spans and counters.

Counterpart: ``ska_sdp_cip_tpu/utils/task_metrics.py``, copied. The
differences: :class:`TaskRecorder`'s default ``worker`` names the
process id instead of asking jax for the process index and device, and
each of its steps also opens a :func:`span` of the step's name.

Each record is a plain dict with the seven columns the reference's
``task-list.json`` carries (``key, worker, status, start, stop, name,
duration`` — reference: src/ska_sdp_cip/task_metrics.py:59-64), so
``pandas.read_json`` analysis written against reference output keeps
working. There is no dask scheduler here: steps of the SPMD program
are timed host-side by :class:`TaskRecorder`. A converter for
task-stream-shaped inputs (per-task ``startstops`` span lists) is
provided for parity with the reference's parser.

Spans and counters (:func:`span`, :func:`count`) mark the program's
phases where the work happens: ``ops/gridder.py:dirty_image`` (root
span ``image``), ``models/operators.py``'s ``residual_gradient``
(``gradient``), ``models/clean.py:hogbom_clean`` (``minor``), staging
(``h2d_bytes``, ``d2h_bytes``) and the mesh's collectives. The recorder
is on inside :func:`tracing` and while a ``torch.profiler`` session
records; otherwise a span costs one check of two flags and returns a
shared null context, and a counter returns at once. While it is on,
each span also opens a ``cip.<name>`` range in the profiler's timeline
of the function kind, which the profiler keeps on the host (a
user-scope ``record_function`` gets a device-side copy that a trace
reader would count as device work). A span opened with ``device=True``
also records two CUDA events on the current stream, read only when the
recorder is read: nothing here synchronizes or reads a tensor.
:func:`count_later` keeps a device tensor of counts as it is, to be read
into the counters by :func:`summary`. Records stay in memory until
:func:`reset`.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Iterator, Union

import torch
from torch.autograd import profiler as _profiler

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
        """Record one named step, inside a :func:`span` of its name;
        exceptions are recorded then re-raised."""
        key = f"{name}-{self._counter:06d}"
        self._counter += 1
        start = time.time()
        status = "OK"
        try:
            with span(name):
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


# --- spans and counters ------------------------------------------------

#: Prefix of the profiler ranges that spans open.
RANGE_PREFIX = "cip."


class SpanRecord:
    """One closed span: ``name``, its ``id``, its ``parent``'s id (the
    span open around it on its thread, or None), its ``root``'s id (the
    outermost such span: one ``dirty_image``, one gradient, one minor
    cycle), host ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns()``, and for a device span its two CUDA
    ``events`` (None on the host clock)."""

    __slots__ = ("name", "id", "parent", "root", "device", "events",
                 "start_ns", "end_ns")

    def __init__(self, name: str, id_: int, parent, device: bool):
        self.name = name
        self.id = id_
        self.parent = None if parent is None else parent.id
        self.root = id_ if parent is None else parent.root
        self.device = device
        self.events = None
        self.start_ns = self.end_ns = 0

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def device_s(self) -> float | None:
        """Seconds between the span's CUDA events once both have
        completed (None before); the host seconds of a device span that
        ran without a card; None for a host span."""
        if not self.device:
            return None
        if self.events is None:
            return self.host_s
        start, end = self.events
        if not end.query():
            return None
        return start.elapsed_time(end) / 1e3

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "root": self.root, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "host_s": self.host_s,
                "device_s": self.device_s}


class SpanRecorder:
    """The process's spans and counters (one instance,
    :data:`RECORDER`); on while :attr:`depth` > 0 (:func:`tracing`) or a
    ``torch.profiler`` session records."""

    def __init__(self):
        self.depth = 0
        self.records: list[SpanRecord] = []
        self.counters: dict[str, int] = {}
        #: (names, tensor) of counts not read yet (:func:`count_later`).
        self.pending: list[tuple] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def stack(self) -> list:
        """This thread's open spans, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def reset(self) -> None:
        self.records = []
        self.counters = {}
        self.pending = []

    def read_pending(self) -> None:
        """Add the pending tensors' values to their counters."""
        with self._lock:
            pending, self.pending = self.pending, []
            for names, values in pending:
                for name, n in zip(names, values.tolist()):
                    self.counters[name] = self.counters.get(name, 0) + int(n)


RECORDER = SpanRecorder()


class _Span:
    """An open span (the recorder is on)."""

    __slots__ = ("record", "_range")

    def __init__(self, name: str, device: bool):
        stack = RECORDER.stack()
        self.record = SpanRecord(name, next(RECORDER._ids),
                                 stack[-1] if stack else None, device)

    def __enter__(self) -> SpanRecord:
        record = self.record
        RECORDER.stack().append(record)
        self._range = torch._C._profiler._RecordFunctionFast(
            RANGE_PREFIX + record.name)
        self._range.__enter__()
        if record.device and torch.cuda.is_initialized():
            record.events = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
            record.events[0].record()
        record.start_ns = time.perf_counter_ns()
        return record

    def __exit__(self, *exc) -> bool:
        record = self.record
        record.end_ns = time.perf_counter_ns()
        if record.events is not None:
            record.events[1].record()
        self._range.__exit__(None, None, None)
        RECORDER.stack().pop()
        RECORDER.records.append(record)
        return False


class _Off:
    """The shared null span of an idle recorder."""

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def enabled() -> bool:
    """Whether spans and counters record now."""
    return bool(RECORDER.depth or _profiler._is_profiler_enabled)


def span(name: str, *, device: bool = False):
    """
    A context manager that records the block as span ``name`` (its
    :class:`SpanRecord` is the ``as`` value; None while the recorder is
    off). ``device=True`` also times the block's work on the current
    CUDA stream by two events, once CUDA is initialized; without a card
    the host clock stands in.
    """
    if not (RECORDER.depth or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while the recorder is on."""
    if not (RECORDER.depth or _profiler._is_profiler_enabled):
        return
    with RECORDER._lock:
        RECORDER.counters[name] = RECORDER.counters.get(name, 0) + int(n)


def count_later(names: list, values: torch.Tensor) -> None:
    """Add ``values[k]`` to counter ``names[k]`` while the recorder is
    on, reading the tensor (which may live on the card and still be
    written by queued work) only when the recorder is read: no
    synchronization here."""
    if not (RECORDER.depth or _profiler._is_profiler_enabled):
        return
    with RECORDER._lock:
        RECORDER.pending.append((list(names), values))


@contextmanager
def tracing() -> Iterator[SpanRecorder]:
    """Keep the recorder on inside the block (blocks nest)."""
    RECORDER.depth += 1
    try:
        yield RECORDER
    finally:
        RECORDER.depth -= 1


def reset() -> None:
    """Drop every record and counter."""
    RECORDER.reset()


def summary() -> dict:
    """
    ``{"spans": {name: totals}, "counters": {name: n}}`` of what was
    recorded since the last :func:`reset` (pending device counts read
    in first, :func:`count_later`). A name's totals: ``count``,
    ``host_s``, ``self_s`` (host seconds less those of its spans'
    children) and, for device spans, ``device_s`` over the spans whose
    events have completed.
    """
    records = list(RECORDER.records)
    RECORDER.read_pending()
    children_ns: dict[int, int] = {}
    for r in records:
        if r.parent is not None:
            children_ns[r.parent] = (children_ns.get(r.parent, 0)
                                     + r.end_ns - r.start_ns)
    spans: dict[str, dict] = {}
    for r in records:
        totals = spans.setdefault(
            r.name, {"count": 0, "host_s": 0.0, "self_s": 0.0})
        totals["count"] += 1
        totals["host_s"] += r.host_s
        totals["self_s"] += (r.end_ns - r.start_ns
                             - children_ns.get(r.id, 0)) / 1e9
        device_s = r.device_s
        if device_s is not None:
            totals["device_s"] = totals.get("device_s", 0.0) + device_s
    return {"spans": spans, "counters": dict(RECORDER.counters)}


def save_spans_json(path: Union[str, os.PathLike]) -> None:
    """Write the span records, :func:`summary`'s totals and the counters
    to ``path``."""
    out = summary()
    out["records"] = [r.as_dict() for r in list(RECORDER.records)]
    with open(path, "w", encoding="utf-8") as file:
        json.dump(out, file, indent=1)
