"""
The port's casacore-free table reader (``io/casacore_tables.py``)
against the JAX package's, on the same bytes: the port of
``tests/test_casacore_tables.py``.

* the module is the JAX module's bytes below its own docstring;
* every case of the JAX tests (direct SSM columns, indirect complex
  columns, TiledColumnStMan, single-cube TiledShapeStMan and the
  rejection of several cubes, IncrementalStMan and its rejection of
  variable shapes, the frozen fixture against its golden JSON, garbage,
  ``ms_to_vz`` with python-casacore absent) reads equal arrays, bit for
  bit, through both readers, or raises each reader's own
  ``CasacoreFormatError`` with the same message;
* ``tests/helpers/ms_writer.py:write_measurement_set`` on a small
  problem: both readers give back the arrays written, with
  WEIGHT_SPECTRUM and with a row-level WEIGHT.
"""

import base64
import io as iolib
import json
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import test_casacore_tables as jtests
from helpers import ms_writer
from helpers.casacore_writer import _write_fake_table

from ska_sdp_cip_tpu.io import casacore_tables as jct
from ska_sdp_cip_tpu.io.ms_ingest import ms_to_vz as jax_ms_to_vz
from ska_sdp_cip_tpu_torch.io import casacore_tables as tct
from ska_sdp_cip_tpu_torch.io.ms_ingest import ms_to_vz
from ska_sdp_cip_tpu_torch.io.synth import make_synthetic_dataset
from ska_sdp_cip_tpu_torch.io.visibility_dataset import VisibilityReader

REPO = Path(__file__).resolve().parent.parent
FIXTURE = jtests.FIXTURE
GOLDEN = jtests.GOLDEN


def test_module_is_a_verbatim_copy():
    ours = (REPO / "ska_sdp_cip_tpu_torch/io/casacore_tables.py").read_text()
    ref = (REPO / "ska_sdp_cip_tpu/io/casacore_tables.py").read_text()
    assert ours.split('"""', 2)[2] == ref.split('"""', 2)[2]
    assert ours.split('"""', 2)[1] != ref.split('"""', 2)[1]


def _bit_equal(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, name
    assert got.shape == want.shape, name
    assert got.tobytes() == want.tobytes(), name


def _both_read(path, truth: dict):
    """Read every column of ``truth`` through both readers: equal to
    each other and to the truth, bit for bit."""
    ours, ref = tct.read_table(path), jct.read_table(path)
    assert ours.num_rows == ref.num_rows
    assert sorted(ours.columns) == sorted(ref.columns)
    for name, want in truth.items():
        got = ours.getcol(name)
        _bit_equal(got, ref.getcol(name), name)
        np.testing.assert_array_equal(got, want, err_msg=name)


def _both_raise(path, column, match):
    """Both readers raise their own CasacoreFormatError, same message."""
    with pytest.raises(tct.CasacoreFormatError, match=match) as ours:
        tct.read_table(path).getcol(column)
    assert not isinstance(ours.value, jct.CasacoreFormatError)
    with pytest.raises(jct.CasacoreFormatError, match=match) as ref:
        jct.read_table(path).getcol(column)
    assert str(ours.value) == str(ref.value)


# Each builder writes the fixture of one JAX test into ``tmp_path``.


def _direct(tmp_path):
    rng = np.random.default_rng(3)
    nrow = 10
    truth = {"UVW": rng.normal(size=(nrow, 3)),
             "TIME": rng.normal(size=nrow),
             "FLAG": rng.random((nrow, 4, 2)) < 0.5}
    _write_fake_table(tmp_path / "t.tbl", [
        ("UVW", jct.TP_DOUBLE, True, (3,), 5, truth["UVW"]),
        ("TIME", jct.TP_DOUBLE, False, (), 0, truth["TIME"]),
        ("FLAG", jct.TP_BOOL, True, (2, 4), 5, truth["FLAG"]),
    ], nrow)
    _both_read(tmp_path / "t.tbl", truth)


def _indirect_complex(tmp_path):
    rng = np.random.default_rng(4)
    nrow, nchan = 6, 3
    truth = {
        "DATA": (rng.normal(size=(nrow, nchan, 4))
                 + 1j * rng.normal(size=(nrow, nchan, 4))).astype(
                     np.complex64),
        "WEIGHT": rng.uniform(0.5, 2.0, (nrow, 4)).astype(np.float32),
    }
    _write_fake_table(tmp_path / "t.tbl", [
        ("DATA", jct.TP_COMPLEX, True, (4, nchan), 0, truth["DATA"]),
        ("WEIGHT", jct.TP_FLOAT, True, (4,), 0, truth["WEIGHT"]),
    ], nrow)
    _both_read(tmp_path / "t.tbl", truth)


def _garbage(tmp_path):
    ms = tmp_path / "bad.ms"
    ms.mkdir()
    (ms / "table.dat").write_bytes(b"\x00" * 64)
    with pytest.raises(tct.CasacoreFormatError, match="Table") as ours:
        tct.read_table(ms)
    assert not isinstance(ours.value, jct.CasacoreFormatError)
    with pytest.raises(jct.CasacoreFormatError) as ref:
        jct.read_table(ms)
    assert str(ours.value) == str(ref.value)


def _tiled_column(tmp_path):
    """The JAX test's TiledColumnStMan fixture: its test writes it and
    reads it with the JAX reader; the port's reader then reads the same
    bytes, left in place."""
    jtests.test_read_tiled_column(tmp_path)
    rng = np.random.default_rng(6)
    data = (rng.normal(size=(10, 5, 4))
            + 1j * rng.normal(size=(10, 5, 4))).astype(np.complex64)
    _both_read(tmp_path / "tsm.tbl", {"DATA": data})


def _tiled_shape(tmp_path):
    jtests.test_read_tiled_shape(tmp_path)
    rng = np.random.default_rng(9)
    data = (rng.normal(size=(11, 5, 4))
            + 1j * rng.normal(size=(11, 5, 4))).astype(np.complex64)
    _both_read(tmp_path / "tssm.tbl", {"DATA": data})


def _tiled_shape_multi_cube(tmp_path):
    jtests.test_tiled_shape_multi_cube_rejected(tmp_path)
    _both_raise(tmp_path / "tssm_bad.tbl", "DATA", "hypercube")


def _ism(tmp_path):
    jtests.test_read_ism_columns(tmp_path)
    ref = jct.read_table(tmp_path / "fake_ism.tbl")
    _both_read(tmp_path / "fake_ism.tbl",
               {name: ref.getcol(name)
                for name in ("TIME", "FIELD_ID", "FLAG_ROW", "UVW")})


def _ism_variable_shape(tmp_path):
    jtests.test_ism_rejects_variable_shape(tmp_path)
    _both_raise(tmp_path / "fake_ism_var.tbl", "BLOB", "variable-shape")


def _frozen_fixture(tmp_path):
    with tarfile.open(jtests.SYNTH_FIXTURE) as tar:
        tar.extractall(tmp_path, filter="data")
    golden = json.loads(jtests.SYNTH_GOLDEN.read_text())
    for table in ("ssm", "ism", "tsm", "tssm"):
        _both_read(tmp_path / f"{table}.ms",
                   {name: jtests._b64_to_npy(b64)
                    for name, b64 in golden[table].items()})
    for key, b64 in golden["ssm_subtables"].items():
        sub, name = key.split("/")
        ours = tct.read_table(tmp_path / "ssm.ms").subtable(sub).getcol(name)
        ref = jct.read_table(tmp_path / "ssm.ms").subtable(sub).getcol(name)
        _bit_equal(ours, ref, key)
        np.testing.assert_array_equal(ours.reshape(-1),
                                      jtests._b64_to_npy(b64).reshape(-1))


def _ms_to_vz_without_casacore(tmp_path, monkeypatch):
    """Both packages' ``ms_to_vz`` with python-casacore absent, through
    their casacore-free readers: the same VZ, file for file."""
    monkeypatch.setitem(sys.modules, "casacore", None)
    monkeypatch.setitem(sys.modules, "casacore.tables", None)
    truth = jtests._write_fake_ms(tmp_path / "native.ms")
    assert type(VisibilityReader(tmp_path / "native.ms")._metadata.backend
                ).__name__ == "_NativeMSBackend"
    ours = ms_to_vz(tmp_path / "native.ms", tmp_path / "ours.vz")
    ref = jax_ms_to_vz(tmp_path / "native.ms", tmp_path / "ref.vz")
    _same_vz(ours, ref)
    reader = VisibilityReader(ours)
    np.testing.assert_array_equal(reader.visibilities(), truth["data"])
    np.testing.assert_array_equal(reader.weights(), truth["weight_spectrum"])


def _same_vz(ours: Path, ref: Path) -> None:
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in ours.iterdir()) == names
    for name in names:
        if name.endswith(".npy"):
            _bit_equal(np.load(ours / name), np.load(ref / name), name)
    meta = [json.loads((p / "metadata.json").read_text()) for p in (ours,
                                                                    ref)]
    for m in meta:
        m.pop("source")
    assert meta[0] == meta[1]


CASES = {
    "read_direct_columns": _direct,
    "read_indirect_complex_column": _indirect_complex,
    "garbage_fails_loudly": _garbage,
    "ms_to_vz_without_casacore": _ms_to_vz_without_casacore,
    "read_tiled_column": _tiled_column,
    "read_tiled_shape": _tiled_shape,
    "tiled_shape_multi_cube_rejected": _tiled_shape_multi_cube,
    "read_ism_columns": _ism,
    "ism_rejects_variable_shape": _ism_variable_shape,
    "frozen_fixture_columns": _frozen_fixture,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_matches_jax(case, tmp_path, monkeypatch):
    build = CASES[case]
    if case == "ms_to_vz_without_casacore":
        build(tmp_path, monkeypatch)
    else:
        build(tmp_path)


@pytest.mark.skipif(
    not (FIXTURE.exists() and GOLDEN.exists()),
    reason="casacore-written fixture not checked in yet "
    "(produced by the ingest-casacore CI job)",
)
def test_golden_fixture_columns(tmp_path):
    with tarfile.open(FIXTURE) as tar:
        tar.extractall(tmp_path)
    golden = json.loads(GOLDEN.read_text())
    ours, ref = tct.read_table(tmp_path / "mini.ms"), jct.read_table(
        tmp_path / "mini.ms")
    assert ours.num_rows == ref.num_rows == golden["num_rows"]
    for name, b64 in golden["columns"].items():
        want = np.load(iolib.BytesIO(base64.b64decode(b64)))
        got = ours.getcol(name)
        _bit_equal(got, ref.getcol(name), name)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("spectrum", [True, False],
                         ids=["weight_spectrum", "row_weight"])
def test_smoke_writer_reads_back(tmp_path, spectrum):
    """``ms_writer.write_measurement_set`` on 3 times x 7 antennas x 4
    channels, in small tiles (several along rows, two along frequency
    for WEIGHT_SPECTRUM, a padded last one): every main-table column
    and subtable through both readers equals the arrays written."""
    vz = make_synthetic_dataset(
        tmp_path / "small.vz", num_times=3, num_antennas=7,
        channel_frequencies=np.linspace(1.0e9, 1.1e9, 4),
        weight_spectrum=spectrum, seed=5)
    columns = ms_writer.vz_columns(vz)
    ms = tmp_path / "small.ms"
    tiles = ms_writer.write_measurement_set(ms, columns, tile_bytes=1024)
    assert len(columns["uvw"]) == 63
    assert tiles["DATA"] == (4, 4, 8) and tiles["UVW"] == (3, 42)
    if spectrum:
        assert tiles["WEIGHT_SPECTRUM"] == (4, 2, 32)
    names = {"UVW": "uvw", "TIME": "time", "DATA": "data", "FLAG": "flag",
             "WEIGHT_SPECTRUM": "weight_spectrum", "WEIGHT": "weight"}
    _both_read(ms, {name: columns[key] for name, key in names.items()
                    if key in columns})
    for sub, name, want in (
        ("SPECTRAL_WINDOW", "CHAN_FREQ", columns["chan_freq"][None]),
        ("SPECTRAL_WINDOW", "NUM_CHAN", np.array([4], np.int32)),
        ("POLARIZATION", "CORR_TYPE", columns["corr_types"][None]),
        ("POLARIZATION", "NUM_CORR", np.array([4], np.int32)),
        ("FIELD", "SOURCE_ID", np.array([0], np.int32)),
    ):
        ours = tct.read_table(ms).subtable(sub).getcol(name)
        _bit_equal(ours, jct.read_table(ms).subtable(sub).getcol(name), name)
        np.testing.assert_array_equal(ours, want, err_msg=name)
    managers = {b.kind for b in tct.read_table(ms).managers}
    assert managers == {"TiledColumnStMan", "TiledShapeStMan",
                        "IncrementalStMan"}
