"""
The port's ``VisibilityReader`` on a VZ dataset and on a MeasurementSet
v2 of the same columns (written by ``tests/helpers/ms_writer.py``,
read by the casacore-free ``_NativeMSBackend``): the ports of
``tests/test_visibility_dataset.py`` and ``tests/test_chunked_read.py``.

* reader basics (absolute path, missing path, the MeerKAT channel
  frequencies, column shapes and dtypes, the row-level WEIGHT repeated
  along frequency, cheap pickling) on both formats;
* layout validation: several spectral windows and corr types outside
  the linear and circular frames raise the port's ``UnsupportedLayout``
  on both formats;
* every partition chunk equals the slice of a whole read, and the JAX
  reader's chunk, on both formats; the MS reads equal the VZ's, bit for
  bit.

Datasets: 4 times x 12 antennas (264 rows) x 4 channels.
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
from helpers import ms_writer
from helpers.casacore_writer import _write_fake_table

from ska_sdp_cip_tpu.io.casacore_tables import TP_DOUBLE, TP_INT
from ska_sdp_cip_tpu.io.visibility_dataset import (
    VisibilityReader as JaxReader,
)
from ska_sdp_cip_tpu_torch.io.synth import (
    MKT_NANO_CHAN_FREQS,
    make_synthetic_dataset,
)
from ska_sdp_cip_tpu_torch.io.visibility_dataset import (
    UnsupportedLayout,
    VisibilityReader,
    _NativeMSBackend,
    write_vz_dataset,
)
from ska_sdp_cip_tpu_torch.utils.chunking import balanced_chunk_bounds

FORMATS = ["vz", "ms"]
CHUNKINGS = [(1, 4), (2, 3), (7, 1)]
COLUMNS = ["visibilities", "flags", "weights", "uvw", "channel_frequencies",
           "time"]


def _as_ms(vz: Path) -> Path:
    ms = vz.with_suffix(".ms")
    ms_writer.write_measurement_set(ms, ms_writer.vz_columns(vz),
                                    tile_bytes=4096)
    return ms


@pytest.fixture(scope="module")
def datasets(tmp_path_factory) -> dict:
    """{format: path} of one synthetic dataset (per-sample weights)."""
    vz = make_synthetic_dataset(tmp_path_factory.mktemp("vd") / "obs.vz",
                                num_times=4, num_antennas=12, seed=17)
    return {"vz": vz, "ms": _as_ms(vz)}


@pytest.fixture(scope="module")
def rowweight_datasets(tmp_path_factory) -> dict:
    """{format: path} of a dataset with only a row-level WEIGHT."""
    vz = make_synthetic_dataset(tmp_path_factory.mktemp("vd") / "rw.vz",
                                num_times=3, num_antennas=12, seed=18,
                                weight_spectrum=False)
    return {"vz": vz, "ms": _as_ms(vz)}


@pytest.fixture(params=FORMATS)
def reader(request, datasets) -> VisibilityReader:
    return VisibilityReader(datasets[request.param])


def test_ms_is_read_by_the_native_backend(datasets):
    assert type(VisibilityReader(datasets["ms"])._metadata.backend) is (
        _NativeMSBackend)


def test_path_is_absolute(reader):
    assert reader.path == reader.path.absolute()


def test_filenotfound_on_nonexistent_path():
    with pytest.raises(FileNotFoundError):
        VisibilityReader("definitely/does/not/exist.vz")


def test_channel_frequencies(reader):
    assert np.array_equal(
        reader.channel_frequencies(),
        [959969726.5625, 960805664.0625, 961641601.5625, 962477539.0625],
    )
    assert np.array_equal(reader.channel_frequencies(), MKT_NANO_CHAN_FREQS)


def test_column_shapes_and_dtypes(reader):
    n = reader.num_data_rows
    assert n == 264
    assert reader.uvw().shape == (n, 3) and reader.uvw().dtype == np.float64
    assert reader.time().shape == (n,)
    assert reader.visibilities().shape == (n, 4, 4)
    assert reader.visibilities().dtype == np.complex64
    assert reader.flags().shape == (n, 4, 4)
    assert reader.flags().dtype == bool
    assert reader.weights().shape == (n, 4, 4)
    assert reader.weights().dtype == np.float32


@pytest.mark.parametrize("fmt", FORMATS)
def test_weight_column_fallback(rowweight_datasets, fmt):
    reader = VisibilityReader(rowweight_datasets[fmt])
    assert not reader._metadata.backend.has_weight_spectrum()
    weights = reader.weights()
    assert weights.shape == (reader.num_data_rows, 4, 4)
    assert np.array_equal(weights[:, 0, :], weights[:, 1, :])
    assert np.array_equal(weights[:, 0, :], weights[:, 3, :])
    np.testing.assert_array_equal(
        weights, VisibilityReader(rowweight_datasets["vz"]).weights())


def test_reader_pickles_cheaply(reader):
    chunk = reader.partition(2, 2)[1]
    clone = pickle.loads(pickle.dumps(chunk))
    assert clone.path == chunk.path
    assert (clone.row_start, clone.row_end) == (chunk.row_start,
                                                chunk.row_end)
    assert (clone.channel_start, clone.channel_end) == (
        chunk.channel_start, chunk.channel_end)
    assert np.array_equal(clone.uvw(), chunk.uvw())
    assert np.array_equal(clone.visibilities(), chunk.visibilities())


def _layout(tmp_path: Path, fmt: str, name: str, **kw) -> Path:
    nrow, nchan = 4, 2
    path = write_vz_dataset(
        tmp_path / f"{name}.vz",
        uvw=np.zeros((nrow, 3)),
        visibilities=np.zeros((nrow, nchan, 4), np.complex64),
        flags=np.zeros((nrow, nchan, 4), bool),
        channel_frequencies=np.linspace(1e9, 1.1e9, nchan),
        weight_spectrum=np.ones((nrow, nchan, 4), np.float32),
        time=np.zeros(nrow), **kw)
    if fmt == "vz":
        return path
    ms = _as_ms(path)
    if kw.get("num_spectral_windows", 1) != 1:
        freqs = np.linspace(1e9, 1.1e9, nchan)
        _write_fake_table(ms / "SPECTRAL_WINDOW", [
            ("CHAN_FREQ", TP_DOUBLE, True, (nchan,), 0,
             np.stack([freqs, freqs + 2e8])),
            ("NUM_CHAN", TP_INT, False, (), 0, np.array([nchan, nchan])),
        ], 2)
    return ms


@pytest.mark.parametrize("fmt", FORMATS)
def test_layout_validation_rejects_bad_corr_types(tmp_path, fmt):
    with pytest.raises(UnsupportedLayout, match="Polarization"):
        VisibilityReader(_layout(tmp_path, fmt, "bad",
                                 corr_types=(1, 2, 3, 4)))
    circular = VisibilityReader(_layout(tmp_path, fmt, "circ",
                                        corr_types=(5, 6, 7, 8)))
    assert circular._metadata.backend.corr_types() == (5, 6, 7, 8)


@pytest.mark.parametrize("fmt", FORMATS)
def test_layout_validation_rejects_multi_spw(tmp_path, fmt):
    path = _layout(tmp_path, fmt, "multispw", num_spectral_windows=2)
    with pytest.raises(UnsupportedLayout, match="spectral windows"):
        VisibilityReader(path)
    with pytest.raises(Exception, match="spectral windows") as ref:
        JaxReader(path)
    assert type(ref.value).__name__ == "UnsupportedLayout"


@pytest.mark.parametrize("column", COLUMNS)
def test_ms_reads_equal_vz_reads(datasets, column):
    ms, vz = VisibilityReader(datasets["ms"]), VisibilityReader(
        datasets["vz"])
    assert ms_writer.bit_equal(getattr(ms, column)(), getattr(vz, column)())


@pytest.mark.parametrize("column", COLUMNS)
@pytest.mark.parametrize("row_chunks,freq_chunks", CHUNKINGS)
def test_chunked_read_equals_whole_read(reader, column, row_chunks,
                                        freq_chunks):
    whole = getattr(reader, column)()
    chunks = reader.partition(row_chunks, freq_chunks)
    jchunks = JaxReader(reader.path).partition(row_chunks, freq_chunks)
    row_bounds = list(balanced_chunk_bounds(0, reader.num_data_rows,
                                            row_chunks))
    chan_bounds = list(balanced_chunk_bounds(0, reader.num_channels,
                                             freq_chunks))
    index = 0
    for r0, r1 in row_bounds:
        for c0, c1 in chan_bounds:
            got = getattr(chunks[index], column)()
            if column in ("uvw", "time"):
                expected = whole[r0:r1]
            elif column == "channel_frequencies":
                expected = whole[c0:c1]
            else:
                expected = whole[r0:r1, c0:c1]
            assert np.array_equal(got, expected), (column, index)
            assert ms_writer.bit_equal(got, getattr(jchunks[index],
                                                    column)())
            index += 1
