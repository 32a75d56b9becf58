"""
The torch port end to end on the CPU, against the JAX package.

* ``invert_dataset`` on a synthetic VZ dataset matches the JAX
  ``invert_dataset`` on its Pallas path (kernels in interpret mode,
  ``CIP_GRIDDER=pallas_interpret``, no executable cache) to 2e-5 of the
  image max — the reference's own Pallas-vs-XLA gap (1.03e-5), doubled
  — and both match the explicit DFT to the 1e-4 contract, with and
  without w-stacking.
* The port imports and runs with jax and ml_dtypes unavailable, as on
  the machine that carries the card: its planner engine, staging, tile
  store, task metrics, the ``tpu-cip-reorder-uvw-torch`` console script
  and the multi-device path (``parallel/*``, ``graft_entry``'s dry run)
  too, and a small MeasurementSet written, read by the casacore-free
  reader, ingested back to its VZ bit for bit and inverted to the VZ's
  image.
* The copied VZ reader and synthetic data give the JAX package's
  arrays; a MeasurementSet whose ``table.dat`` does not parse raises
  ``CasacoreFormatError``.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ska_sdp_cip_tpu
import ska_sdp_cip_tpu_torch
from ska_sdp_cip_tpu.io import synth as jsynth
from ska_sdp_cip_tpu.io.visibility_dataset import (
    VisibilityReader as JaxReader,
)
from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
from ska_sdp_cip_tpu_torch.invert import (
    StokesIGridderInput,
    integrate_weighted_images,
    pixel_size_lm_from_asec,
)
from ska_sdp_cip_tpu_torch.io import synth as tsynth
from ska_sdp_cip_tpu_torch.io.casacore_tables import CasacoreFormatError
from ska_sdp_cip_tpu_torch.ops.dft import dirty_image_dft

torch.set_num_threads(1)

NPIX = 128
ASEC = 30.0
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_port") / "obs.vz"
    return tsynth.make_synthetic_dataset(
        path, num_times=6, num_antennas=16, seed=4321
    )


@pytest.mark.parametrize("wstack", [True, False], ids=["wstack", "no_wstack"])
def test_invert_dataset_matches_jax_and_dft(dataset, wstack, monkeypatch):
    from ska_sdp_cip_tpu import invert_dataset as jax_invert_dataset

    ours = invert_dataset(
        VisibilityReader(dataset), NPIX, ASEC, do_wstacking=wstack,
        device="cpu",
    )
    monkeypatch.setenv("CIP_GRIDDER", "pallas_interpret")
    monkeypatch.setenv("CIP_AOT", "0")
    ref = jax_invert_dataset(
        JaxReader(dataset), NPIX, ASEC, do_wstacking=wstack
    )
    assert ours.shape == ref.shape == (NPIX, NPIX)
    assert ours.dtype == np.float32
    scale = np.abs(ref).max()
    assert np.abs(ours - ref).max() / scale <= 2 * 1.03e-5

    gi = StokesIGridderInput.from_reader(VisibilityReader(dataset))
    weights = gi.effective_weights()
    dft = dirty_image_dft(
        gi.uvw, gi.channel_frequencies, gi.visibilities, weights, NPIX,
        pixel_size_lm_from_asec(ASEC), apply_w=wstack,
    ) / weights.sum()
    dft_scale = np.abs(dft).max()
    assert np.abs(ours - dft).max() / dft_scale <= 1e-4
    assert np.abs(ref - dft).max() / dft_scale <= 1e-4


def test_invert_dataset_options(dataset):
    reader = VisibilityReader(dataset)
    with pytest.raises(ValueError, match="weighting scheme"):
        invert_dataset(reader, NPIX, ASEC, weighting="briggs", device="cpu")
    with pytest.raises(TypeError):
        invert_dataset(reader, NPIX, ASEC)  # no device: none is picked
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            invert_dataset(reader, NPIX, ASEC, device="cuda")
    halves = reader.partition(2, 1)
    from ska_sdp_cip_tpu_torch.invert import grid_invert

    parts = [
        grid_invert(StokesIGridderInput.from_reader(r), NPIX, ASEC,
                    device="cpu")
        for r in halves
    ]
    whole = invert_dataset(reader, NPIX, ASEC, device="cpu")
    combined = integrate_weighted_images(parts)
    np.testing.assert_allclose(
        combined, whole, atol=1e-5 * np.abs(whole).max()
    )


def test_ms2dirty_matches_dirty_image(dataset):
    from ska_sdp_cip_tpu_torch.ops.gridder import dirty_image
    from ska_sdp_cip_tpu_torch.wgridder import ms2dirty

    gi = StokesIGridderInput.from_reader(VisibilityReader(dataset))
    pix = pixel_size_lm_from_asec(ASEC)
    wgt = gi.effective_weights()
    image = ms2dirty(
        gi.uvw, gi.channel_frequencies, gi.visibilities, wgt, NPIX, NPIX,
        pix, pix, 1e-4, True, nthreads=4, device="cpu",
    )
    ref = dirty_image(
        gi.uvw, gi.channel_frequencies, gi.visibilities, wgt, NPIX, pix,
        device="cpu",
    )
    np.testing.assert_array_equal(image, ref)
    with pytest.raises(NotImplementedError):
        ms2dirty(gi.uvw, gi.channel_frequencies, gi.visibilities, wgt,
                 NPIX, NPIX // 2, pix, pix, device="cpu")


_NO_JAX_SCRIPT = """
import json, sys
for name in ("jax", "jaxlib", "ml_dtypes", "ska_sdp_cip_tpu"):
    sys.modules[name] = None
import numpy as np
import ska_sdp_cip_tpu_torch
from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw
from ska_sdp_cip_tpu_torch.ops.dft import dirty_image_dft
from ska_sdp_cip_tpu_torch.ops.gridder import dirty_image
rng = np.random.default_rng(1)
uvw, _ = synthetic_uvw(3, 8, max_baseline_m=3000.0, seed=2)
freqs = np.array([1.0e9, 1.05e9])
vis = (rng.normal(size=(len(uvw), 2)) + 1j).astype(np.complex64)
wgt = np.ones(vis.shape, np.float32)
pix = float(np.sin(np.radians(40.0 / 3600)))
img = dirty_image(uvw, freqs, vis, wgt, 64, pix, device="cpu")
ref = dirty_image_dft(uvw, freqs, vis, wgt, 64, pix)
from ska_sdp_cip_tpu_torch.models import MeasurementOperator, major_cycle_clean
op = MeasurementOperator.build(uvw, freqs, wgt, 64, pix, device="cpu")
model, res = major_cycle_clean(op, vis.ravel(), num_major=1, minor_iter=5)
assert np.isfinite(res.numpy()).all()
import ska_sdp_cip_tpu_torch.uvw_tiling.tiled_invert
from ska_sdp_cip_tpu_torch import native
from ska_sdp_cip_tpu_torch.apps import uvw_reorder_app
from ska_sdp_cip_tpu_torch.utils import staging, task_metrics
uvw_reorder_app.get_parser().parse_args(["obs.vz", "-t", "1", "2", "3"])
task_metrics.TaskRecorder()
staging.device_put_parallel({"x": np.zeros(2)}, "cpu")
from ska_sdp_cip_tpu_torch import graft_entry, sharded_invert_dataset
from ska_sdp_cip_tpu_torch.parallel import launch, mesh, sharded_clean
graft_entry.dryrun_multichip(2, "cpu")
launch.get_parser().parse_args(["--", "obs.vz", "out.npy"])
import tempfile
from pathlib import Path
sys.path.insert(0, "tests")  # its helpers, before any installed tests package
from helpers.ms_writer import bit_equal, vz_columns, write_measurement_set
from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
from ska_sdp_cip_tpu_torch.apps import ingest_app
from ska_sdp_cip_tpu_torch.io.synth import make_synthetic_dataset
with tempfile.TemporaryDirectory() as tmp:
    vz = make_synthetic_dataset(Path(tmp) / "s.vz", num_times=3,
                                num_antennas=8)
    ms = Path(tmp) / "s.ms"
    write_measurement_set(ms, vz_columns(vz), tile_bytes=2048)
    ms_reader = VisibilityReader(ms)
    backend = type(ms_reader._metadata.backend).__name__
    ingest_app.run_program([str(ms), str(Path(tmp) / "i.vz")])
    ingested = all(bit_equal(np.load(p), np.load(Path(tmp) / "i.vz" / p.name))
                   for p in vz.glob("*.npy"))
    ms_img = invert_dataset(ms_reader, 64, 40.0, device="cpu")
    vz_img = invert_dataset(VisibilityReader(vz), 64, 40.0, device="cpu")
    ms_err = float(np.abs(ms_img - vz_img).max())
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "ml_dtypes", "ska_sdp_cip_tpu")
                and sys.modules[m] is not None)
print(json.dumps({"err": float(np.abs(img - ref).max() / np.abs(ref).max()),
                  "loaded": loaded, "backend": backend,
                  "ingested": ingested, "ms_err": ms_err}))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert result["err"] <= 1e-4
    assert result["backend"] == "_NativeMSBackend"
    assert result["ingested"] and result["ms_err"] == 0.0


def test_port_sources_import_no_jax():
    """No import of jax, ml_dtypes or the JAX package in the port."""
    banned = ("jax", "jaxlib", "ml_dtypes", "ska_sdp_cip_tpu")
    root = Path(ska_sdp_cip_tpu_torch.__file__).parent
    sources = list(root.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests/helpers/ms_writer.py"]
    for source in sources:
        tree = ast.parse(source.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (source, name)


def test_synth_and_reader_match_jax(tmp_path):
    uvw, time = tsynth.synthetic_uvw(5, 9, seed=3)
    ref_uvw, ref_time = jsynth.synthetic_uvw(5, 9, seed=3)
    np.testing.assert_array_equal(uvw, ref_uvw)
    np.testing.assert_array_equal(time, ref_time)
    for spectrum in (True, False):
        ours = tsynth.make_synthetic_dataset(
            tmp_path / f"ours{spectrum}.vz", num_times=3, num_antennas=7,
            weight_spectrum=spectrum, seed=11,
        )
        ref = jsynth.make_synthetic_dataset(
            tmp_path / f"ref{spectrum}.vz", num_times=3, num_antennas=7,
            weight_spectrum=spectrum, seed=11,
        )
        assert sorted(p.name for p in ours.iterdir()) == sorted(
            p.name for p in ref.iterdir()
        )
        for column in ours.glob("*.npy"):
            np.testing.assert_array_equal(
                np.load(column), np.load(ref / column.name)
            )
        assert json.loads((ours / "metadata.json").read_text()) == json.loads(
            (ref / "metadata.json").read_text()
        )
        reader, jreader = VisibilityReader(ref), JaxReader(ref)
        for r, j in zip(reader.partition(2, 3), jreader.partition(2, 3)):
            assert (r.row_start, r.row_end, r.channel_start,
                    r.channel_end) == (j.row_start, j.row_end,
                                       j.channel_start, j.channel_end)
            for accessor in ("channel_frequencies", "time", "uvw", "flags",
                             "visibilities", "weights"):
                np.testing.assert_array_equal(
                    getattr(r, accessor)(), getattr(j, accessor)()
                )
    ms = tmp_path / "fake.ms"
    ms.mkdir()
    (ms / "table.dat").write_bytes(b"")
    with pytest.raises(CasacoreFormatError, match="Table"):
        VisibilityReader(ms)
    assert ska_sdp_cip_tpu_torch.__version__ == ska_sdp_cip_tpu.__version__
    assert ska_sdp_cip_tpu_torch.MeasurementSetReader is VisibilityReader
