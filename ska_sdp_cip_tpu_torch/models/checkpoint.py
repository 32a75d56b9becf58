"""
Major-cycle checkpoint / resume.

The reference has no checkpointing — a SLURM kill loses all partial
work (SURVEY.md section 5: SIGTERM arrives 120 s before the kill and
nothing catches it, reference: slurm/csd3_icelake.sh:13). Here the
major cycle checkpoints its state (CLEAN model, residual, cycle
counter, config fingerprint) after every cycle, and a SIGTERM flushes
the latest state before exit, so a preempted run resumes where it
stopped.

Format: a single ``.npz`` per run (atomic rename), no service deps.
"""

from __future__ import annotations

import json
import os
import signal
from contextlib import contextmanager
from pathlib import Path

import numpy as np

CHECKPOINT_NAME = "major_cycle_state.npz"


class MajorCycleCheckpoint:
    """Checkpoint store for one major-cycle run."""

    def __init__(self, directory: os.PathLike, config: dict) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.path = self.directory / CHECKPOINT_NAME
        self.config = dict(config)

    def save(self, cycle: int, model, residual) -> None:
        """Atomically persist post-cycle state."""
        tmp_path = self.path.with_suffix(".tmp.npz")
        np.savez(
            tmp_path,
            cycle=np.int64(cycle),
            model=np.asarray(model),
            residual=np.asarray(residual),
            config=np.frombuffer(
                json.dumps(self.config, sort_keys=True).encode(),
                dtype=np.uint8,
            ),
        )
        os.replace(tmp_path, self.path)

    def load(self):
        """
        Returns ``(cycle, model, residual)`` from a matching checkpoint,
        or None when absent or written under a different configuration.
        """
        if not self.path.is_file():
            return None
        with np.load(self.path) as data:
            stored = json.loads(bytes(data["config"]).decode())
            if stored != self.config:
                return None
            return (
                int(data["cycle"]),
                data["model"].copy(),
                data["residual"].copy(),
            )


@contextmanager
def graceful_shutdown(flush):
    """
    Invoke ``flush()`` (e.g. a final checkpoint save) when SIGTERM or
    SIGINT arrives — covering the reference's uncaught pre-kill warning
    (slurm/csd3_icelake.sh:13) — then re-raise as KeyboardInterrupt.
    """
    triggered = {}

    def handler(signum, frame):
        triggered["signal"] = signum
        flush()
        raise KeyboardInterrupt(f"signal {signum}")

    previous = {
        signum: signal.signal(signum, handler)
        for signum in (signal.SIGTERM, signal.SIGINT)
    }
    try:
        yield triggered
    finally:
        for signum, old in previous.items():
            signal.signal(signum, old)
