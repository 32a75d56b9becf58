"""
The imaging and reorder CLIs of the port on a MeasurementSet v2, on
the CPU (``--device cpu``; the JAX side on its XLA path). The MS is a
synthetic dataset's columns written by ``tests/helpers/ms_writer.py``
(4 times x 12 antennas = 264 rows x 4 channels) and read by the
casacore-free ``_NativeMSBackend`` on both sides.

* ``tpu-cip-torch small.ms`` equals ``tpu-cip small.ms`` within
  ``IMAGE_RTOL`` (``tests/test_torch_pipeline_app.py``) and
  ``tpu-cip-torch small.vz`` within 1e-6 of the max;
* ``-d 2`` on the MS equals the single-device image at rtol and atol
  1e-5, and ``-d 2`` on the VZ within 1e-6 of the max (every shard's
  reader decodes the MS again: the reference's behaviour);
* ``tpu-cip-reorder-uvw-torch small.ms`` writes the tiles that it
  writes from ``small.vz``, file for file, bit for bit (each time
  interval's reader decodes the MS in its worker).
"""

import numpy as np
import pytest
import torch
from helpers import ms_writer

from ska_sdp_cip_tpu.apps import pipeline_app as japp
from ska_sdp_cip_tpu_torch.apps import pipeline_app as tapp
from ska_sdp_cip_tpu_torch.apps import uvw_reorder_app
from ska_sdp_cip_tpu_torch.io.synth import make_synthetic_dataset

torch.set_num_threads(1)

NPIX, ASEC = 128, 30.0
IMAGE_RTOL = 2 * 1.03e-5  # tests/test_torch_pipeline_app.py


@pytest.fixture(scope="module")
def small(tmp_path_factory) -> dict:
    vz = make_synthetic_dataset(tmp_path_factory.mktemp("slice") / "small.vz",
                                num_times=4, num_antennas=12, seed=1234)
    ms = vz.with_suffix(".ms")
    ms_writer.write_measurement_set(ms, ms_writer.vz_columns(vz),
                                    tile_bytes=4096)
    return {"vz": vz, "ms": ms}


def _args(dataset, out, *extra):
    return [str(dataset), str(out), "-n", str(NPIX), "-p", str(ASEC), *extra]


def _rel(got, ref) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_cli_on_ms_matches_jax_cli(small, tmp_path):
    tapp.run_program(_args(small["ms"], tmp_path / "ours.npy", "--device",
                           "cpu"))
    japp.run_program(_args(small["ms"], tmp_path / "ref.npy"))
    ours, ref = np.load(tmp_path / "ours.npy"), np.load(tmp_path / "ref.npy")
    assert ours.shape == ref.shape == (NPIX, NPIX)
    assert np.isfinite(ours).all()
    assert _rel(ours, ref) <= IMAGE_RTOL


def test_cli_on_ms_equals_cli_on_vz(small, tmp_path):
    for fmt in ("ms", "vz"):
        tapp.run_program(_args(small[fmt], tmp_path / f"{fmt}.npy",
                               "--device", "cpu"))
    ms, vz = np.load(tmp_path / "ms.npy"), np.load(tmp_path / "vz.npy")
    assert _rel(ms, vz) <= 1e-6


def test_sharded_cli_on_ms(small, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for fmt in ("ms", "vz"):
        tapp.run_program(_args(small[fmt], tmp_path / f"d_{fmt}.npy", "-d",
                               "2", "-rc", "2", "-fc", "1", "--device",
                               "cpu"))
    tapp.run_program(_args(small["ms"], tmp_path / "single.npy", "--device",
                           "cpu"))
    sharded, single = (np.load(tmp_path / name)
                       for name in ("d_ms.npy", "single.npy"))
    np.testing.assert_allclose(sharded, single, rtol=1e-5,
                               atol=1e-5 * np.abs(single).max())
    assert _rel(sharded, np.load(tmp_path / "d_vz.npy")) <= 1e-6


def test_reorder_cli_on_ms_writes_the_vz_tiles(small, tmp_path,
                                               monkeypatch):
    monkeypatch.chdir(tmp_path)  # the CLI writes task-list.json here
    for fmt in ("ms", "vz"):
        uvw_reorder_app.run_program([
            str(small[fmt]), "-t", "3000", "3000", "6000", "-o",
            str(tmp_path / fmt), "-n", "2", "-m", "10000", "-j", "2"])
    ms_tiles = sorted((tmp_path / "ms").glob("*.npz"))
    vz_tiles = sorted((tmp_path / "vz").glob("*.npz"))
    assert ms_tiles and [p.name for p in ms_tiles] == [p.name
                                                        for p in vz_tiles]
    for ours, ref in zip(ms_tiles, vz_tiles):
        a, b = np.load(ours), np.load(ref)
        assert sorted(a.files) == sorted(b.files), ours.name
        for key in b.files:
            assert ms_writer.bit_equal(a[key], b[key]), (ours.name, key)
