"""Shared fixtures of the harness's tests: a copy of the benchmark with
its configurations cut to a size the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

#: The configurations' geometry and sky cut to a CPU test's size.
TINY = {
    "observation": {"num_antennas": 6, "layout_disc_diameter_m": 200.0,
                    "num_dumps": 8, "num_channels": 4},
    "imaging": {"num_pixels": 64, "pixel_size_asec": 60.0,
                "minor_iter": 20},
    "sky": {"num_sources": 3},
    "check": {"sample_pixels": 8},
}


def shrink(cfg: dict) -> dict:
    for group, values in TINY.items():
        cfg[group].update(values)
    # The program's rule picks no PSF patch below 4096 px.
    cfg["imaging"]["minor_psf_patch"] = None
    return cfg


@pytest.fixture
def tiny_root(tmp_path, monkeypatch) -> Path:
    """A checkout root holding BENCHMARK.json and cipbench/ with tiny
    configurations, and TMPDIR inside the test's folder."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cipbench", tmp_path / "cipbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for path in (tmp_path / "cipbench" / "configs").glob("*.json"):
        path.write_text(json.dumps(shrink(json.loads(path.read_text()))))
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr("tempfile.tempdir", None)
    torch.set_num_threads(1)
    return tmp_path


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
