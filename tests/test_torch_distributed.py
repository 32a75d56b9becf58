"""
The port's multi-device path across real processes on the CPU
(counterpart: ``tests/test_distributed_multiprocess.py``): two gloo
ranks, each ``python -m ska_sdp_cip_tpu_torch.parallel.launch`` joined
to an explicit world on a free loopback port, run ``tpu-cip-torch -d``
with one or two shards a rank:

* the invert (replicated), the distributed-FFT invert and the
  distributed-FFT major cycle (with a checkpoint directory) against the
  same run on one process over the same shards, at rtol 1e-5 (atol 1e-5
  of the max); each rank waits at most 120 s;
* ``initialize_distributed`` does nothing once the group is up and
  refuses an explicit world it cannot join;
* ``graft_entry``: ``entry`` runs, ``dryrun_multichip(4, "cpu")`` holds
  the sharded step to the serial one.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu_torch import VisibilityReader, graft_entry
from ska_sdp_cip_tpu_torch.parallel.mesh import (
    free_port,
    initialize_distributed,
    make_device_mesh,
)
from ska_sdp_cip_tpu_torch.parallel.sharded_clean import (
    sharded_major_cycle_clean,
)
from ska_sdp_cip_tpu_torch.parallel.sharded_invert import (
    sharded_invert_dataset,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NUM_PIXELS = 128
PIXEL_SIZE_ASEC = 30.0
EPS = 1e-5
CLEAN = dict(num_major=2, gain=0.3, minor_iter=6)
WAIT_S = 120


def _run_ranks(tmp_path, app_args, fft_mode) -> None:
    """Two ranks of an explicit world, each running ``app_args``."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ska_sdp_cip_tpu_torch.parallel.launch",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(rank), "--fft-mode", fft_mode, "--",
             *app_args],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for rank in range(2)
    ]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=WAIT_S)[0].decode(
                errors="replace"))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, output in zip(procs, outputs):
        assert proc.returncode == 0, f"rank failed:\n{output[-4000:]}"


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=EPS,
                               atol=EPS * np.abs(want).max())


@pytest.mark.parametrize("per_rank", [1, 2], ids=["1_shard", "2_shards"])
@pytest.mark.parametrize("kind", ["invert", "distributed_invert",
                                  "distributed_clean"])
def test_two_processes_match_one(dataset_path, tmp_path, kind, per_rank):
    shards = 2 * per_rank
    fft_mode = "replicated" if kind == "invert" else "distributed"
    out = tmp_path / "image.npy"
    args = [str(dataset_path), str(out), "-n", str(NUM_PIXELS), "-p",
            str(PIXEL_SIZE_ASEC), "-d", str(shards), "-rc", str(shards),
            "-fc", "1", "--device", "cpu"]
    if kind == "distributed_clean":
        args += ["--clean", str(CLEAN["num_major"]), "--gain",
                 str(CLEAN["gain"]), "--minor-iter", str(CLEAN["minor_iter"]),
                 "--checkpoint-dir", str(tmp_path / "ckpt")]
    _run_ranks(tmp_path, args, fft_mode)

    reader = VisibilityReader(dataset_path)
    mesh = make_device_mesh(shards, device="cpu")
    kwargs = dict(mesh=mesh, row_chunks=shards, freq_chunks=1,
                  sigma="auto", fft_mode=fft_mode)
    local = sharded_invert_dataset(reader, NUM_PIXELS, PIXEL_SIZE_ASEC,
                                   **kwargs)
    _assert_close(np.load(out), local)
    assert (tmp_path / "task-list.json").is_file()
    if kind == "distributed_clean":
        model, residual, _ = sharded_major_cycle_clean(
            reader, NUM_PIXELS, PIXEL_SIZE_ASEC, **kwargs, **CLEAN)
        scale = np.abs(residual).max()
        for name, want in (("model", model), ("residual", residual)):
            got = np.load(tmp_path / f"image.{name}.npy")
            np.testing.assert_allclose(got, want, rtol=EPS,
                                       atol=EPS * scale, err_msg=name)
        assert (tmp_path / "ckpt" / "major_cycle_state.npz").is_file()


def test_initialize_distributed_is_idempotent_and_strict():
    make_device_mesh(1, device="cpu")
    before = torch.distributed.get_world_size()
    initialize_distributed()  # the group is up: nothing happens
    assert torch.distributed.get_world_size() == before
    code = (
        "from ska_sdp_cip_tpu_torch.parallel.mesh import "
        "initialize_distributed\n"
        "initialize_distributed('127.0.0.1:1', num_processes=2, "
        "process_id=5)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=WAIT_S,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode != 0 and "process_id 5" in proc.stderr


def test_graft_entry_runs_and_dryrun_passes():
    fn, args = graft_entry.entry("cpu")
    image = fn(*args)
    assert image.shape == (128, 128) and float(image.abs().max()) > 0
    errors = graft_entry.dryrun_multichip(4, "cpu")
    assert set(errors) == {"replicated", "distributed"}
    assert max(errors.values()) < graft_entry.DRYRUN_RTOL
