"""
What the traced run reads: host spans around the program's functions,
and the device's work from ``torch.profiler``.

Spans are wrappers put, from the benchmark's side, around functions that
the entry calls, found as module attributes (``"module:Class.attr"``).
Each wrapper times its call on the host clock, synchronizes the card at
its end and marks its interval in the profiler's timeline
(``record_function("cipbench::<span>")``). An attribute that is gone
gets no wrapper, so the metrics that read it report nothing: that is how
a rename shows.

The profiler reader is a frozen copy of ``chip_smoke.py:profile_call``'s
use of ``torch.profiler`` (device events of one session; sessions drop
kernel records now and then and never add any), with the union of the
device intervals for the busy time and the idle gaps between them.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

PREFIX = "cipbench::"

#: Kernel names (substrings) of each kernel layer: B2 (``stage1_kernel``,
#: ``stage2_kernel``) and B2L (``last_stage*_kernel``) and any library
#: FFT; B1 (``grid_chunks_kernel``) and B3 (``degrid_chunks_kernel``).
LAYER_KERNELS = {
    "fft": ("stage1_kernel", "stage2_kernel", "fft"),
    "gridding": ("grid_chunks_kernel",),
}


def resolve(target: str):
    """(owner, attribute name, raw attribute) of ``"module:a.b.c"``, or
    None if any part is gone."""
    module_name, _, path = target.partition(":")
    try:
        owner = importlib.import_module(module_name)
    except ImportError:
        return None
    parts = path.split(".")
    for part in parts[:-1]:
        owner = getattr(owner, part, None)
        if owner is None:
            return None
    name = parts[-1]
    raw = (owner.__dict__.get(name) if isinstance(owner, type)
           else getattr(owner, name, None))
    return None if raw is None else (owner, name, raw)


class Spans:
    """Host spans of named program functions, installed while the
    context is open."""

    def __init__(self, targets: dict, sync: bool):
        self.targets = targets
        self.sync = sync
        self.seconds = defaultdict(list)
        self._undo = []

    def _wrap(self, span: str, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(PREFIX + span):
                out = fn(*args, **kwargs)
                if self.sync:
                    torch.cuda.synchronize()
            self.seconds[span].append(time.perf_counter() - t0)
            return out

        return wrapper

    def __enter__(self):
        for span, target in self.targets.items():
            found = resolve(target)
            if found is None:
                continue
            owner, name, raw = found
            if isinstance(raw, (classmethod, staticmethod)):
                new = type(raw)(self._wrap(span, raw.__func__))
            else:
                new = self._wrap(span, raw)
            setattr(owner, name, new)
            self._undo.append((owner, name, raw))
        return self

    def __exit__(self, *exc):
        for owner, name, raw in reversed(self._undo):
            setattr(owner, name, raw)
        self._undo.clear()


@dataclass
class Trace:
    """Device events of the traced window, in seconds from its start."""

    window_s: float
    #: (name, start, end) of every device operation inside the window.
    ops: list = field(default_factory=list)
    #: (name, start, end) of every benchmark span inside the window.
    spans: list = field(default_factory=list)

    def busy_intervals(self) -> list:
        merged = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def seconds_of(self, layer: str) -> float:
        keys = LAYER_KERNELS[layer]
        return sum(b - a for name, a, b in self.ops
                   if any(k in name.lower() for k in keys))

    def device_ops(self, top: int = 10) -> list:
        by_name = defaultdict(float)
        for name, a, b in self.ops:
            by_name[name[:120]] += b - a
        return sorted(([n, s] for n, s in by_name.items()),
                      key=lambda r: -r[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds of the device, split by the span the host was in
        (a cell's spans follow one another, none inside another)."""
        by_label = defaultdict(float)
        edge = 0.0
        for a, b in self.busy_intervals() + [[self.window_s, self.window_s]]:
            if a > edge:
                covered = 0.0
                for name, s, e in self.spans:
                    overlap = min(a, e) - max(edge, s)
                    if overlap > 0:
                        by_label["idle in " + name] += overlap
                        covered += overlap
                by_label["idle outside spans"] += (a - edge) - covered
            edge = max(edge, b)
        return sorted(([n, s] for n, s in by_label.items() if s > 0),
                      key=lambda r: -r[1])[:top]


@contextlib.contextmanager
def profiled(enabled: bool):
    """A ``torch.profiler`` session (CPU and CUDA activity) around the
    block, or nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def read_trace(prof) -> Trace | None:
    """The window's device operations and spans from a session whose
    window was marked with ``record_function("cipbench::window")``;
    None where it saw no device operation."""
    from torch.autograd import DeviceType

    host, device = [], []
    for evt in prof.events():
        rng = (evt.name, evt.time_range.start / 1e6, evt.time_range.end / 1e6)
        if evt.name.startswith(PREFIX):
            if evt.device_type == DeviceType.CPU:
                host.append(rng)
        elif evt.device_type == DeviceType.CUDA:
            device.append(rng)
    windows = [r for r in host if r[0] == PREFIX + "window"]
    if not windows or not device:
        return None
    _, w0, w1 = windows[0]

    def clip(rows):
        return [(n[len(PREFIX):] if n.startswith(PREFIX) else n,
                 max(a, w0) - w0, min(b, w1) - w0)
                for n, a, b in rows if b > w0 and a < w1]

    return Trace(window_s=w1 - w0, ops=clip(device),
                 spans=[s for s in clip(host) if s[0] != "window"])
