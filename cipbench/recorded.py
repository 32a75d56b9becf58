"""
What the program's own span recorder holds after a traced run
(``ska_sdp_cip_tpu_torch/utils/task_metrics.py``: ``summary()``, span
totals by name and counters). The recorder is on only while a
``torch.profiler`` session records, and the traced run's session is the
window, so what it holds is the window's. A program without the
recorder, or a recorder that holds nothing, gives None: the metric is
left out of the line.
"""

from __future__ import annotations


def summary() -> dict | None:
    try:
        from ska_sdp_cip_tpu_torch.utils import task_metrics
    except ImportError:
        return None
    read = getattr(task_metrics, "summary", None)
    if read is None:
        return None
    out = read()
    return out if out["spans"] or out["counters"] else None


def span_seconds(names: list, clock: str) -> float | None:
    """Seconds on ``clock`` (``"host_s"`` or ``"device_s"``) of every
    span named in ``names``; None where none of them was recorded."""
    out = summary()
    if out is None:
        return None
    found = [out["spans"][n][clock] for n in names
             if clock in out["spans"].get(n, {})]
    return sum(found) if found else None


def counter(name: str) -> int | None:
    out = summary()
    return None if out is None else out["counters"].get(name)
