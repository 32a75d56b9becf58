"""
Helpers of the metric readers (``metrics/<name>.py``). A reader returns
None where it finds nothing to read, and the run leaves that metric out.
"""

from __future__ import annotations

import statistics


def per_call(run, unit: str, value: float | None) -> float | None:
    """``value`` over the window's calls, in a cell whose calls are
    ``unit``s."""
    if run.unit != unit or value is None or not run.calls:
        return None
    return value / len(run.calls)


def span_per_call(run, unit: str, span: str) -> float | None:
    """Host seconds a call spent in ``span``, over the window."""
    seconds = run.spans.get(span)
    return per_call(run, unit, sum(seconds) if seconds else None)


def p90(run, unit: str) -> float | None:
    if run.unit != unit or len(run.calls) < 10:
        return None
    return statistics.quantiles(run.calls, n=10, method="inclusive")[8]


def roofline(run, unit: str, layer: str) -> float | None:
    """Percent: the least time of the window's work in ``layer``
    (``work.py``) over the device time of the layer's kernels."""
    if run.unit != unit or run.trace is None or layer not in run.bounds:
        return None
    seconds = run.trace.seconds_of(layer)
    if seconds <= 0:
        return None
    return 100.0 * run.bounds[layer] / seconds


def idle_share(run, unit: str) -> float | None:
    """Percent of the traced window in which no operation ran on the
    device."""
    if run.unit != unit or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
