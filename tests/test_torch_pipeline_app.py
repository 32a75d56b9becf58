"""
The port's CLI (``tpu-cip-torch``, ``apps/pipeline_app.py``) against
the JAX package's ``tpu-cip``, on the CPU (``--device cpu``; the JAX
side on its XLA path).

* every option of the JAX parser has the same option strings, dest,
  default, choices, nargs, type and ``required`` in the port's, which
  adds ``--device`` (default ``cuda``) and nothing else;
* ``--device cpu`` writes the port's ``invert_dataset`` image, bit for
  bit, with natural and robust weighting; ``--device cuda`` without a
  card raises rather than falls back;
* ``--clean 1`` with each algorithm writes the four files and matches
  the JAX CLI's: the dirty image to 2 x 1.03e-5 of its max (the JAX
  package's Pallas-vs-XLA gap, doubled), model, residual and restored
  image to 1e-4 of their max;
* ``-d 2 --device cpu`` writes ``invert_dataset``'s image (rtol 1e-5)
  and ``task-list.json`` in the reference's schema; ``--version``
  prints;
* ``python -m ska_sdp_cip_tpu_torch.apps.pipeline_app`` runs with jax,
  jaxlib, ml_dtypes and the JAX package unimportable, and
  ``--profile-dir`` writes a trace.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.apps import pipeline_app as japp
from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
from ska_sdp_cip_tpu_torch.apps import pipeline_app as tapp

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NPIX, ASEC = 64, 30.0
IMAGE_RTOL = 2 * 1.03e-5
SOLVER_RTOL = 1e-4
OUTPUTS = (".npy", ".model.npy", ".residual.npy", ".restored.npy")


def _options(parser) -> dict:
    return {a.dest: a for a in parser._actions if a.dest != "help"}


JAX_OPTIONS = _options(japp.get_parser())


@pytest.mark.parametrize("dest", sorted(JAX_OPTIONS))
def test_option_matches_jax(dest):
    ref = JAX_OPTIONS[dest]
    ours = _options(tapp.get_parser())[dest]
    for attr in ("option_strings", "default", "choices", "nargs", "type",
                 "required", "const"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert type(ours) is type(ref)


def test_device_is_the_one_added_option():
    ours = _options(tapp.get_parser())
    assert set(ours) - set(JAX_OPTIONS) == {"device"}
    assert ours["device"].default == "cuda"
    assert ours["device"].option_strings == ["--device"]


def _args(dataset, out, *extra):
    return [str(dataset), str(out), "-n", str(NPIX), "-p", str(ASEC),
            *extra]


@pytest.mark.parametrize("weighting", ["natural", "robust"])
def test_cpu_invert_equals_invert_dataset(dataset_path, tmp_path, weighting):
    out = tmp_path / "dirty.npy"
    tapp.run_program(_args(dataset_path, out, "--device", "cpu",
                           "--weighting", weighting, "--robust", "0.5"))
    want = invert_dataset(VisibilityReader(dataset_path), NPIX, ASEC,
                          weighting=weighting, robust=0.5, sigma="auto",
                          device="cpu")
    np.testing.assert_array_equal(np.load(out), want)
    assert not (tmp_path / "dirty.model.npy").exists()


def test_cuda_without_a_card_raises(dataset_path, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tapp.run_program(_args(dataset_path, tmp_path / "x.npy"))
    assert not (tmp_path / "x.npy").exists()


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("algorithm", ["hogbom", "multiscale", "fista"])
def test_clean_matches_jax_cli(dataset_path, tmp_path, monkeypatch,
                               algorithm):
    monkeypatch.chdir(tmp_path)
    extra = ("--clean", "1", "--algorithm", algorithm, "--minor-iter", "30",
             "--weighting", "uniform")
    japp.run_program(_args(dataset_path, tmp_path / "ref.npy", *extra))
    tapp.run_program(_args(dataset_path, tmp_path / "ours.npy", *extra,
                           "--device", "cpu"))
    for suffix in OUTPUTS:
        ours = np.load(tmp_path / f"ours{suffix}")
        ref = np.load(tmp_path / f"ref{suffix}")
        assert ours.shape == ref.shape == (NPIX, NPIX), suffix
        assert np.isfinite(ours).all(), suffix
        rtol = IMAGE_RTOL if suffix == ".npy" else SOLVER_RTOL
        assert _rel(ours, ref) <= rtol, suffix
    model = np.load(tmp_path / "ours.model.npy")
    assert model.max() > 0
    if algorithm == "fista":
        assert model.min() >= 0


def test_devices_raise_and_version(dataset_path, tmp_path, monkeypatch,
                                   capsys):
    """``-d 2 --device cpu`` (two shards on a gloo world of one) writes
    the image of ``invert_dataset`` at the reference's tolerance and a
    ``task-list.json`` in the reference's schema; ``-d`` with ``--device
    cuda`` and no card raises."""
    monkeypatch.chdir(tmp_path)
    tapp.run_program(_args(dataset_path, tmp_path / "d.npy", "-d", "2",
                           "-rc", "2", "-fc", "1", "--device", "cpu"))
    want = invert_dataset(VisibilityReader(dataset_path), NPIX, ASEC,
                          sigma="auto", device="cpu")
    np.testing.assert_allclose(np.load(tmp_path / "d.npy"), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    tasks = json.loads((tmp_path / "task-list.json").read_text())
    assert [t["name"] for t in tasks] == [
        "load_shards", "plan_shards", "stage_shards", "grid_fft_reduce"]
    assert set(tasks[0]) == {"key", "worker", "status", "start", "stop",
                             "name", "duration"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tapp.run_program(_args(dataset_path, tmp_path / "c.npy", "-d",
                                   "2", "--device", "cuda"))
        assert not (tmp_path / "c.npy").exists()
    with pytest.raises(SystemExit):
        tapp.run_program(["--version"])
    assert capsys.readouterr().out.strip() == tapp.__version__


_BLOCK_JAX = """
import sys
for name in ("jax", "jaxlib", "ml_dtypes", "ska_sdp_cip_tpu"):
    sys.modules[name] = None
"""


def test_module_entry_point_runs_without_jax(dataset_path, tmp_path):
    """``python -m`` with jax unimportable: a ``sitecustomize`` on the
    path blocks jax, jaxlib, ml_dtypes and the JAX package before the
    app starts, so any import of them fails the run."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCK_JAX)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), str(REPO)]))
    out = tmp_path / "sub.npy"
    proc = subprocess.run(
        [sys.executable, "-m", "ska_sdp_cip_tpu_torch.apps.pipeline_app",
         *_args(dataset_path, out, "--device", "cpu", "--clean", "1",
                "--algorithm", "multiscale", "--minor-iter", "10",
                "--weighting", "robust", "--profile-dir",
                str(tmp_path / "prof"))],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    for suffix in OUTPUTS:
        assert np.load(tmp_path / f"sub{suffix}").shape == (NPIX, NPIX)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    check = subprocess.run(
        [sys.executable, "-c", "import jax"], capture_output=True,
        text=True, timeout=60, env=env,
    )
    assert check.returncode != 0
