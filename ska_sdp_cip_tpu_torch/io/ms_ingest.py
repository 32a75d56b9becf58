"""
One-shot MSv2 -> VZ ingest converter (``ms_to_vz``).

Counterpart: ``ska_sdp_cip_tpu/io/ms_ingest.py``, carried as a copy:
below this docstring the two files are the same bytes
(``tests/test_torch_ms_ingest.py`` holds them so). The MS is read
through ``VisibilityReader``: python-casacore where it is importable,
else the casacore-free reader (``io/casacore_tables.py``). Row blocks
stream into memory-mapped ``.npy`` files, so memory is bounded by the
block (plus, on the casacore-free reader, its whole-column decode).
Weights keep the source's granularity: WEIGHT_SPECTRUM as it is, a
row-level WEIGHT as ``(nrows, 4)``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .visibility_dataset import (
    VZ_METADATA_FILENAME,
    PathLike,
    VisibilityReader,
)


def ms_to_vz(
    ms_path: PathLike,
    vz_path: PathLike,
    *,
    row_block: int = 1_000_000,
) -> Path:
    """
    Convert a MeasurementSet v2 into a VZ dataset directory, preserving
    layout validation semantics (the source MS must satisfy the same
    restrictions the reference enforces,
    reference: measurement_set.py:77-105).
    """
    reader = VisibilityReader(ms_path)  # validates layout
    backend = reader._metadata.backend  # noqa: SLF001 — ingest internals
    num_rows = reader.num_data_rows
    num_channels = reader.num_channels

    vz_path = Path(vz_path)
    vz_path.mkdir(parents=True, exist_ok=True)

    chan_freq = reader.channel_frequencies()
    np.save(vz_path / "chan_freq.npy", np.asarray(chan_freq, np.float64))

    # Stream row blocks into pre-allocated memmapped outputs. Weights
    # keep the source MS's granularity: a per-sample WEIGHT_SPECTRUM
    # column converts as-is, but a row-level WEIGHT column stays
    # (nrows, npol) — materializing it along frequency would blow up
    # the store nchan-fold for nothing (the VZ reader broadcasts on
    # demand, _VZBackend.weights).
    has_spectrum = backend.has_weight_spectrum()
    columns = {
        "uvw.npy": ((num_rows, 3), np.float64),
        "data.npy": ((num_rows, num_channels, 4), np.complex64),
        "flag.npy": ((num_rows, num_channels, 4), bool),
        "time.npy": ((num_rows,), np.float64),
    }
    if has_spectrum:
        columns["weight_spectrum.npy"] = (
            (num_rows, num_channels, 4),
            np.float32,
        )
    else:
        columns["weight.npy"] = ((num_rows, 4), np.float32)
    outputs = {
        name: np.lib.format.open_memmap(
            vz_path / name, mode="w+", dtype=dtype, shape=shape
        )
        for name, (shape, dtype) in columns.items()
    }

    for start in range(0, num_rows, row_block):
        stop = min(start + row_block, num_rows)
        outputs["uvw.npy"][start:stop] = backend.uvw(start, stop)
        outputs["data.npy"][start:stop] = backend.visibilities(
            start, stop, 0, num_channels
        )
        outputs["flag.npy"][start:stop] = backend.flags(
            start, stop, 0, num_channels
        )
        if has_spectrum:
            outputs["weight_spectrum.npy"][start:stop] = backend.weights(
                start, stop, 0, num_channels
            )
        else:
            outputs["weight.npy"][start:stop] = backend.row_weights(
                start, stop
            )
        outputs["time.npy"][start:stop] = backend.time(start, stop)

    for array in outputs.values():
        array.flush()

    metadata = {
        "format": "vz",
        "format_version": 1,
        "num_rows": int(num_rows),
        "num_channels": int(num_channels),
        "num_polarizations": 4,
        "corr_types": [int(c) for c in backend.corr_types()],
        "num_spectral_windows": 1,
        "num_fields": 1,
        "num_polarization_rows": 1,
        "source": str(Path(ms_path).resolve()),
    }
    with open(vz_path / VZ_METADATA_FILENAME, "w", encoding="utf-8") as file:
        json.dump(metadata, file, indent=2)
    return vz_path
