"""
The port's MSv2 ingest (``io/ms_ingest.py``, the MS backends of
``io/visibility_dataset.py`` and ``tpu-cip-ingest-torch``) against the
JAX package's: the port of ``tests/test_ms_ingest.py``.

* ``io/ms_ingest.py`` is the JAX module's bytes below its own docstring;
* a stubbed ``casacore.tables`` drives ``_CasacoreBackend``: whole and
  windowed reads equal the stub's columns and the JAX reader's;
* ``ms_to_vz`` writes the JAX ``ms_to_vz``'s VZ, file for file and bit
  for bit, with WEIGHT_SPECTRUM and with a row-level WEIGHT (kept as
  ``(nrows, 4)``), at a row block below the row count and at the
  default, through the stub and through the casacore-free reader;
* with python-casacore missing the casacore-free reader takes over and
  unparseable bytes raise its ``CasacoreFormatError``;
* ``tpu-cip-ingest-torch`` takes ``tpu-cip-ingest``'s options and
  writes its VZ.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
from helpers import ms_writer

# The JAX tests' stubbed python-casacore and fake MS (24 rows, 4
# channels): the stub serves both packages' ``_CasacoreBackend``.
from test_ms_ingest import fake_ms  # noqa: F401

from ska_sdp_cip_tpu.apps import ingest_app as japp
from ska_sdp_cip_tpu.io.ms_ingest import ms_to_vz as jax_ms_to_vz
from ska_sdp_cip_tpu.io.visibility_dataset import (
    VisibilityReader as JaxReader,
)
from ska_sdp_cip_tpu_torch.apps import ingest_app as tapp
from ska_sdp_cip_tpu_torch.io import visibility_dataset as tvd
from ska_sdp_cip_tpu_torch.io.casacore_tables import CasacoreFormatError
from ska_sdp_cip_tpu_torch.io.ms_ingest import ms_to_vz
from ska_sdp_cip_tpu_torch.io.synth import make_synthetic_dataset

REPO = Path(__file__).resolve().parent.parent


def test_module_is_a_verbatim_copy():
    ours = (REPO / "ska_sdp_cip_tpu_torch/io/ms_ingest.py").read_text()
    ref = (REPO / "ska_sdp_cip_tpu/io/ms_ingest.py").read_text()
    assert ours.split('"""', 2)[2] == ref.split('"""', 2)[2]


def _same_vz(ours: Path, ref: Path) -> None:
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in ours.iterdir()) == names
    for name in names:
        if name.endswith(".npy"):
            a, b = np.load(ours / name), np.load(ref / name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
    meta = [json.loads((p / "metadata.json").read_text())
            for p in (ours, ref)]
    for m in meta:
        m.pop("source")
    assert meta[0] == meta[1]


def test_ms_reader_columns(fake_ms):
    ms_path, main, freqs = fake_ms
    reader = tvd.VisibilityReader(ms_path)
    assert type(reader._metadata.backend) is tvd._CasacoreBackend
    assert reader.num_data_rows == 24
    assert reader.num_channels == 4
    np.testing.assert_array_equal(reader.channel_frequencies(), freqs)
    np.testing.assert_array_equal(reader.uvw(), main["UVW"])
    np.testing.assert_array_equal(reader.visibilities(), main["DATA"])
    jreader = JaxReader(ms_path)
    for ours, ref in zip(reader.partition(2, 2), jreader.partition(2, 2)):
        for accessor in ("channel_frequencies", "time", "uvw", "flags",
                         "visibilities", "weights"):
            np.testing.assert_array_equal(getattr(ours, accessor)(),
                                          getattr(ref, accessor)())
    np.testing.assert_array_equal(reader.partition(2, 2)[3].visibilities(),
                                  main["DATA"][12:, 2:4])


@pytest.mark.parametrize("row_block", [7, None], ids=["block7", "default"])
@pytest.mark.parametrize("spectrum", [True, False],
                         ids=["weight_spectrum", "row_weight"])
def test_ms_to_vz_matches_jax(fake_ms, tmp_path, rng, spectrum, row_block):
    ms_path, main, _ = fake_ms
    if not spectrum:
        del main["WEIGHT_SPECTRUM"]
        main["WEIGHT"] = rng.uniform(0.5, 2.0, size=(24, 4)).astype(
            np.float32)
    kw = {} if row_block is None else {"row_block": row_block}
    ours = ms_to_vz(ms_path, tmp_path / "ours.vz", **kw)
    ref = jax_ms_to_vz(ms_path, tmp_path / "ref.vz", **kw)
    _same_vz(ours, ref)
    assert (ours / "weight_spectrum.npy").is_file() == spectrum
    assert (ours / "weight.npy").is_file() != spectrum
    reader = tvd.VisibilityReader(ours)
    np.testing.assert_array_equal(reader.visibilities(), main["DATA"])
    np.testing.assert_array_equal(reader.flags(), main["FLAG"])
    want = (main["WEIGHT_SPECTRUM"] if spectrum else
            np.repeat(main["WEIGHT"][:, None], 4, axis=1))
    np.testing.assert_array_equal(reader.weights(), want)


@pytest.fixture()
def no_casacore(monkeypatch):
    monkeypatch.setitem(sys.modules, "casacore", None)
    monkeypatch.setitem(sys.modules, "casacore.tables", None)


def test_missing_casacore_falls_back_to_native_reader(tmp_path,
                                                      no_casacore):
    ms_path = tmp_path / "no_casacore.ms"
    ms_path.mkdir()
    (ms_path / "table.dat").write_bytes(b"fake")
    with pytest.raises(CasacoreFormatError, match="Table"):
        tvd.VisibilityReader(ms_path)


@pytest.mark.parametrize("row_block", [50, None], ids=["block50",
                                                       "default"])
@pytest.mark.parametrize("spectrum", [True, False],
                         ids=["weight_spectrum", "row_weight"])
def test_native_ms_to_vz_matches_jax(tmp_path, no_casacore, spectrum,
                                     row_block):
    """An MS in the smoke's layout (tiled columns, TIME in
    IncrementalStMan; 198 rows) through both casacore-free readers: the
    same VZ, and the source VZ back, bit for bit."""
    vz = make_synthetic_dataset(tmp_path / "src.vz", num_times=3,
                                num_antennas=12, weight_spectrum=spectrum,
                                seed=8)
    ms = tmp_path / "src.ms"
    ms_writer.write_measurement_set(ms, ms_writer.vz_columns(vz),
                                    tile_bytes=2048)
    assert type(tvd.VisibilityReader(ms)._metadata.backend) is (
        tvd._NativeMSBackend)
    kw = {} if row_block is None else {"row_block": row_block}
    ours = ms_to_vz(ms, tmp_path / "ours.vz", **kw)
    _same_vz(ours, jax_ms_to_vz(ms, tmp_path / "ref.vz", **kw))
    for name in sorted(p.name for p in vz.glob("*.npy")):
        assert ms_writer.bit_equal(np.load(ours / name),
                                   np.load(vz / name)), name


def _options(parser):
    return {a.dest: (a.option_strings, a.default, a.nargs, a.type,
                     a.required)
            for a in parser._actions if a.dest != "help"}


def test_ingest_arguments_are_the_jax_cli_arguments():
    assert _options(tapp.get_parser()) == _options(japp.get_parser())


def test_ingest_cli(fake_ms, tmp_path, capsys):
    ms_path, main, _ = fake_ms
    tapp.run_program([str(ms_path), str(tmp_path / "cli.vz"),
                      "--row-block", "7"])
    japp.run_program([str(ms_path), str(tmp_path / "ref.vz"),
                      "--row-block", "7"])
    _same_vz(tmp_path / "cli.vz", tmp_path / "ref.vz")
    np.testing.assert_array_equal(
        tvd.VisibilityReader(tmp_path / "cli.vz").uvw(), main["UVW"])
    capsys.readouterr()
    with pytest.raises(SystemExit):
        tapp.run_program(["--version"])
    assert capsys.readouterr().out.strip() == tapp.__version__


def test_casacore_backend_without_casacore_names_the_port(tmp_path,
                                                          no_casacore):
    with pytest.raises(ImportError, match="ska_sdp_cip_tpu_torch"):
        tvd._CasacoreBackend(tmp_path)

