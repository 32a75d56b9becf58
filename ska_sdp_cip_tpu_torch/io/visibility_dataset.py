"""
Columnar visibility store and windowed reader (VZ backend).

Counterpart: ``ska_sdp_cip_tpu/io/visibility_dataset.py``
(``VisibilityReader``, the VZ backend and ``write_vz_dataset``), copied
because the port cannot import the JAX package. The MeasurementSet v2
backends are not carried yet: opening an MS raises
``NotImplementedError`` (ROADMAP.md, queue A: the MS reader).

The reader is a cheap, picklable view = path + row bounds + channel
bounds, with the reference's ``partition(row_chunks, freq_chunks)``
semantics.
"""

from __future__ import annotations

import json
import os
from functools import cached_property
from pathlib import Path
from typing import Union

import numpy as np
from numpy.typing import NDArray

PathLike = Union[str, os.PathLike]

#: Accepted POLARIZATION CORR_TYPE rows: linear (XX, XY, YX, YY) or
#: circular (RR, RL, LR, LL) frames
#: (reference: measurement_set.py:96-105).
ACCEPTED_CORR_TYPES = {
    (9, 10, 11, 12),
    (5, 6, 7, 8),
}

VZ_METADATA_FILENAME = "metadata.json"


class UnsupportedLayout(Exception):
    """
    Raised when a dataset layout deviates from what is supported
    (reference: measurement_set.py:12-16).
    """


# Backwards-compatible alias with the reference exception name.
UnsupportedMeasurementSetLayout = UnsupportedLayout


def is_vz_dataset(path: PathLike) -> bool:
    """True if ``path`` looks like a native VZ dataset directory."""
    return (Path(path) / VZ_METADATA_FILENAME).is_file()


def is_measurement_set(path: PathLike) -> bool:
    """True if ``path`` looks like a casacore MeasurementSet v2."""
    return (Path(path) / "table.dat").is_file()


class VisibilityDatasetMetadata:
    """
    Layout metadata and validation for a visibility dataset
    (reference: MeasurementSetMetadata, measurement_set.py:53-127).

    Enforced layout restrictions (reference: measurement_set.py:77-105):
    exactly one spectral window, one field, one polarization row, and a
    linear or circular 4-product correlation frame.
    """

    def __init__(
        self, path: PathLike, *, validate_layout: bool = True
    ) -> None:
        self._path = Path(path).resolve()
        if not self._path.is_dir():
            raise FileNotFoundError(
                "Cannot initialise visibility dataset: path is not a "
                f"directory: {self._path}"
            )
        self._backend = _open_backend(self._path)
        if validate_layout:
            self._validate_layout()

    def _validate_layout(self) -> None:
        if self._backend.num_spectral_windows() != 1:
            raise UnsupportedLayout(
                "Multiple spectral windows are not supported"
            )
        if self._backend.num_fields() != 1:
            raise UnsupportedLayout("Multiple fields are not supported")
        if self._backend.num_polarization_rows() != 1:
            raise UnsupportedLayout(
                "Mixed polarization rows are not supported"
            )
        corr_types = tuple(int(c) for c in self._backend.corr_types())
        if corr_types not in ACCEPTED_CORR_TYPES:
            raise UnsupportedLayout(
                "Polarization channels must be either XX, XY, YX, YY or "
                "RR, RL, LR, LL"
            )

    @property
    def path(self) -> Path:
        """Absolute path on disk."""
        return self._path

    @property
    def backend(self) -> "_Backend":
        """The storage backend serving this dataset."""
        return self._backend

    @property
    def num_data_rows(self) -> int:
        """Total number of data rows."""
        return self._backend.num_rows()

    @cached_property
    def num_channels(self) -> int:
        """Total number of frequency channels."""
        return self._backend.num_channels()


class VisibilityReader:
    """
    Windowed reader over a visibility dataset: stores a path plus reading
    bounds along rows and frequency channels
    (reference: MeasurementSetReader, measurement_set.py:130-358).

    Instances are cheap to create and pickle (path + 4 ints); column
    accessors return numpy arrays restricted to the bounds.

    Example
    -------
    >>> reader = VisibilityReader("path/to/dataset.vz")
    >>> reader.set_row_bounds(0, 1_000_000)
    >>> reader.set_channel_bounds(16, 32)
    """

    def __init__(
        self, path: PathLike, *, validate_layout: bool = True
    ) -> None:
        self._metadata = VisibilityDatasetMetadata(
            path, validate_layout=validate_layout
        )
        self._row_start = 0
        self._row_end = self._metadata.num_data_rows
        self._channel_start = 0
        self._channel_end = self._metadata.num_channels

    # -- pickling: drop the backend (holds mmaps), rebuild lazily --
    def __getstate__(self) -> dict:
        return {
            "path": str(self.path),
            "row_bounds": (self._row_start, self._row_end),
            "channel_bounds": (self._channel_start, self._channel_end),
        }

    def __setstate__(self, state: dict) -> None:
        self._metadata = VisibilityDatasetMetadata(
            state["path"], validate_layout=False
        )
        self._row_start, self._row_end = state["row_bounds"]
        self._channel_start, self._channel_end = state["channel_bounds"]

    @property
    def path(self) -> Path:
        """Absolute path on disk."""
        return self._metadata.path

    @property
    def row_start(self) -> int:
        """Absolute start row index (inclusive)."""
        return self._row_start

    @property
    def row_end(self) -> int:
        """Absolute end row index (exclusive)."""
        return self._row_end

    @property
    def num_data_rows(self) -> int:
        """Number of rows within the reading bounds."""
        return self._row_end - self._row_start

    @property
    def channel_start(self) -> int:
        """Absolute start channel index (inclusive)."""
        return self._channel_start

    @property
    def channel_end(self) -> int:
        """Absolute end channel index (exclusive)."""
        return self._channel_end

    @property
    def num_channels(self) -> int:
        """Number of frequency channels within the reading bounds."""
        return self._channel_end - self._channel_start

    def set_row_bounds(self, row_start: int, row_end: int) -> None:
        """
        Set reading bounds along rows; out-of-bounds arguments are
        clipped. Start inclusive, end exclusive.
        """
        self._row_start = max(row_start, 0)
        self._row_end = min(row_end, self._metadata.num_data_rows)

    def set_channel_bounds(self, channel_start: int, channel_end: int) -> None:
        """
        Set reading bounds along frequency channels; out-of-bounds
        arguments are clipped. Start inclusive, end exclusive.
        """
        self._channel_start = max(channel_start, 0)
        self._channel_end = min(channel_end, self._metadata.num_channels)

    def partition(
        self, row_chunks: int, freq_chunks: int
    ) -> list["VisibilityReader"]:
        """
        Partition into ``row_chunks x freq_chunks`` balanced sub-readers,
        row-major (all channel chunks of the first row chunk first) —
        identical semantics to the reference
        (measurement_set.py:234-277), golden-tested against its expected
        bounds.
        """
        from ..utils.chunking import balanced_chunk_bounds

        if not 1 <= row_chunks <= self.num_data_rows:
            raise ValueError(
                "Number of row chunks must be within [1, total data rows]"
            )
        if not 1 <= freq_chunks <= self.num_channels:
            raise ValueError(
                "Number of freq chunks must be within "
                "[1, total freq channels]"
            )

        result = []
        for row_bounds in balanced_chunk_bounds(
            self._row_start, self._row_end, row_chunks
        ):
            for channel_bounds in balanced_chunk_bounds(
                self._channel_start, self._channel_end, freq_chunks
            ):
                reader = VisibilityReader(self.path, validate_layout=False)
                reader.set_row_bounds(*row_bounds)
                reader.set_channel_bounds(*channel_bounds)
                result.append(reader)
        return result

    # -- column accessors (bounded) ------------------------------------

    @property
    def _backend(self) -> "_Backend":
        return self._metadata.backend

    def channel_frequencies(self) -> NDArray:
        """Channel frequencies in Hz, shape ``(num_channels,)``."""
        return self._backend.channel_frequencies(
            self._channel_start, self._channel_end
        )

    def time(self) -> NDArray:
        """Row timestamps (seconds), shape ``(num_data_rows,)``."""
        return self._backend.time(self._row_start, self._row_end)

    def uvw(self) -> NDArray:
        """UVW coordinates in meters, shape ``(num_data_rows, 3)``."""
        return self._backend.uvw(self._row_start, self._row_end)

    def flags(self) -> NDArray:
        """Boolean flags, shape ``(num_data_rows, num_channels, 4)``."""
        return self._backend.flags(
            self._row_start,
            self._row_end,
            self._channel_start,
            self._channel_end,
        )

    def visibilities(self) -> NDArray:
        """Visibilities, shape ``(num_data_rows, num_channels, 4)``."""
        return self._backend.visibilities(
            self._row_start,
            self._row_end,
            self._channel_start,
            self._channel_end,
        )

    def weights(self) -> NDArray:
        """
        Per-sample weights, shape ``(num_data_rows, num_channels, 4)``:
        the WEIGHT_SPECTRUM column if present, else the row-level WEIGHT
        column repeated along frequency
        (reference: measurement_set.py:334-358).
        """
        return self._backend.weights(
            self._row_start,
            self._row_end,
            self._channel_start,
            self._channel_end,
        )


# ----------------------------------------------------------------------
# Storage backends
# ----------------------------------------------------------------------


def _open_backend(path: Path) -> "_Backend":
    if is_vz_dataset(path):
        return _VZBackend(path)
    if is_measurement_set(path):
        raise NotImplementedError(
            "The torch port reads VZ datasets only; the MeasurementSet "
            "reader is still to be ported (ROADMAP.md, queue A). "
            f"Convert {path} to VZ with ska_sdp_cip_tpu.io.ms_ingest."
        )
    raise FileNotFoundError(
        f"Not a VZ dataset or MeasurementSet v2: {path} "
        "(expected metadata.json or table.dat inside)"
    )


class _Backend:
    """Interface for column storage backends."""

    def num_rows(self) -> int:
        raise NotImplementedError

    def num_channels(self) -> int:
        raise NotImplementedError

    def num_spectral_windows(self) -> int:
        raise NotImplementedError

    def num_fields(self) -> int:
        raise NotImplementedError

    def num_polarization_rows(self) -> int:
        raise NotImplementedError

    def corr_types(self) -> tuple:
        raise NotImplementedError

    def channel_frequencies(self, c0: int, c1: int) -> NDArray:
        raise NotImplementedError

    def time(self, r0: int, r1: int) -> NDArray:
        raise NotImplementedError

    def uvw(self, r0: int, r1: int) -> NDArray:
        raise NotImplementedError

    def flags(self, r0: int, r1: int, c0: int, c1: int) -> NDArray:
        raise NotImplementedError

    def visibilities(self, r0: int, r1: int, c0: int, c1: int) -> NDArray:
        raise NotImplementedError

    def weights(self, r0: int, r1: int, c0: int, c1: int) -> NDArray:
        raise NotImplementedError

    def has_weight_spectrum(self) -> bool:
        """True if per-sample WEIGHT_SPECTRUM data is stored."""
        raise NotImplementedError

    def row_weights(self, r0: int, r1: int) -> NDArray:
        """Row-level WEIGHT column, shape ``(nrows, npol)``."""
        raise NotImplementedError


class _VZBackend(_Backend):
    """
    Native columnar backend: ``metadata.json`` plus one ``.npy`` per
    column, windowed reads via numpy memory maps. Rows are the slowest-
    varying axis of every data column, so a row-chunked read is one
    contiguous byte range per column — the layout the multi-host ingest
    shards along.
    """

    def __init__(self, path: Path) -> None:
        self.path = path
        with open(path / VZ_METADATA_FILENAME, encoding="utf-8") as file:
            self.meta = json.load(file)
        self._mmaps: dict[str, NDArray] = {}

    def _column(self, name: str) -> NDArray:
        if name not in self._mmaps:
            self._mmaps[name] = np.load(
                self.path / f"{name}.npy", mmap_mode="r"
            )
        return self._mmaps[name]

    def _has_column(self, name: str) -> bool:
        return (self.path / f"{name}.npy").is_file()

    def num_rows(self) -> int:
        return int(self.meta["num_rows"])

    def num_channels(self) -> int:
        return int(self.meta["num_channels"])

    def num_spectral_windows(self) -> int:
        return int(self.meta.get("num_spectral_windows", 1))

    def num_fields(self) -> int:
        return int(self.meta.get("num_fields", 1))

    def num_polarization_rows(self) -> int:
        return int(self.meta.get("num_polarization_rows", 1))

    def corr_types(self) -> tuple:
        return tuple(self.meta["corr_types"])

    def channel_frequencies(self, c0: int, c1: int) -> NDArray:
        return np.asarray(self._column("chan_freq")[c0:c1])

    def time(self, r0: int, r1: int) -> NDArray:
        return np.asarray(self._column("time")[r0:r1])

    def uvw(self, r0: int, r1: int) -> NDArray:
        return np.asarray(self._column("uvw")[r0:r1])

    def flags(self, r0: int, r1: int, c0: int, c1: int) -> NDArray:
        return np.asarray(self._column("flag")[r0:r1, c0:c1])

    def visibilities(self, r0: int, r1: int, c0: int, c1: int) -> NDArray:
        return np.asarray(self._column("data")[r0:r1, c0:c1])

    def weights(self, r0: int, r1: int, c0: int, c1: int) -> NDArray:
        if self._has_column("weight_spectrum"):
            return np.asarray(self._column("weight_spectrum")[r0:r1, c0:c1])
        # Row-level WEIGHT (nrows, npol), repeated along frequency
        # (reference: measurement_set.py:334-358).
        weight = np.asarray(self._column("weight")[r0:r1])
        nrow, npol = weight.shape
        return np.broadcast_to(
            weight.reshape(nrow, 1, npol), (nrow, c1 - c0, npol)
        ).copy()

    def has_weight_spectrum(self) -> bool:
        return self._has_column("weight_spectrum")

    def row_weights(self, r0: int, r1: int) -> NDArray:
        return np.asarray(self._column("weight")[r0:r1])


# ----------------------------------------------------------------------
# VZ writer
# ----------------------------------------------------------------------


def write_vz_dataset(
    path: PathLike,
    *,
    uvw: NDArray,
    visibilities: NDArray,
    flags: NDArray,
    channel_frequencies: NDArray,
    weights: NDArray | None = None,
    weight_spectrum: NDArray | None = None,
    time: NDArray | None = None,
    corr_types: tuple = (9, 10, 11, 12),
    num_spectral_windows: int = 1,
    num_fields: int = 1,
    num_polarization_rows: int = 1,
) -> Path:
    """
    Write a VZ dataset directory from column arrays.

    ``weights`` is the row-level WEIGHT column ``(nrows, npol)``;
    ``weight_spectrum`` the per-sample column ``(nrows, nchan, npol)``.
    Provide at least one of the two.
    """
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)

    num_rows, num_channels, num_pols = visibilities.shape
    if weights is None and weight_spectrum is None:
        raise ValueError("Provide weights and/or weight_spectrum")

    np.save(path / "uvw.npy", np.asarray(uvw, dtype=np.float64))
    np.save(path / "data.npy", np.asarray(visibilities, dtype=np.complex64))
    np.save(path / "flag.npy", np.asarray(flags, dtype=bool))
    np.save(
        path / "chan_freq.npy",
        np.asarray(channel_frequencies, dtype=np.float64),
    )
    if weight_spectrum is not None:
        np.save(
            path / "weight_spectrum.npy",
            np.asarray(weight_spectrum, dtype=np.float32),
        )
    if weights is not None:
        np.save(path / "weight.npy", np.asarray(weights, dtype=np.float32))
    if time is not None:
        np.save(path / "time.npy", np.asarray(time, dtype=np.float64))

    metadata = {
        "format": "vz",
        "format_version": 1,
        "num_rows": int(num_rows),
        "num_channels": int(num_channels),
        "num_polarizations": int(num_pols),
        "corr_types": [int(c) for c in corr_types],
        "num_spectral_windows": int(num_spectral_windows),
        "num_fields": int(num_fields),
        "num_polarization_rows": int(num_polarization_rows),
    }
    with open(path / VZ_METADATA_FILENAME, "w", encoding="utf-8") as file:
        json.dump(metadata, file, indent=2)
    return path
