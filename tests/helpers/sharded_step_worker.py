"""
One rank of a two-rank gloo world running the port's sharded Hogbom step
(``parallel/sharded_clean.py:build_sharded_major_cycle_step``) on the
CPU, one channel chunk of a VZ a rank.

The rank loads its shard in memory and stages it through
``stage_loaded_shards``; stages the same dataset again through
``stage_sharded_inputs`` and records whether every staged array is
equal; runs two steps from the dirty image, keeping the residual and PSF
each minor cycle was handed (a capture on ``models.clean.hogbom_clean``,
which the step looks up at each call); then runs
``sharded_major_cycle_clean`` for as many cycles; and writes it all to
an npz.

Usage (spawned by tests/test_torch_sharded_step.py):
    python sharded_step_worker.py <rank> <port> <dataset> <out.npz>
"""

import sys
from pathlib import Path

# Spawned as a bare script: put the checkout's root on sys.path.
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

NUM_PIXELS = 128
PIXEL_SIZE_ASEC = 30.0
CYCLES = 2
CLEAN = dict(gain=0.3, minor_iter=6)
#: One row chunk, one channel chunk a rank.
CHUNKS = dict(row_chunks=1, freq_chunks=2)


def _staged_equal(a, b) -> bool:
    """Whether two stagings hold the same plans' arrays and samples."""
    if a.total_weight != b.total_weight or len(a.arrays) != len(b.arrays):
        return False
    for arrays_a, arrays_b in zip(a.arrays, b.arrays):
        if sorted(arrays_a) != sorted(arrays_b):
            return False
        if not all(torch.equal(arrays_a[k], arrays_b[k]) for k in arrays_a):
            return False
    lists = ("vis_re", "vis_im", "weights", "dup_a", "dup_b")
    return all(torch.equal(x, y) for name in lists
               for x, y in zip(getattr(a, name), getattr(b, name)))


def main() -> None:
    rank, port, dataset, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
    torch.set_num_threads(1)
    from ska_sdp_cip_tpu_torch import VisibilityReader
    from ska_sdp_cip_tpu_torch.invert import StokesIGridderInput
    from ska_sdp_cip_tpu_torch.models import clean
    from ska_sdp_cip_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_device_mesh,
        shutdown_distributed,
    )
    from ska_sdp_cip_tpu_torch.parallel.sharded_clean import (
        ShardedOperator,
        build_sharded_major_cycle_step,
        sharded_major_cycle_clean,
    )
    from ska_sdp_cip_tpu_torch.parallel.sharded_invert import (
        stage_loaded_shards,
        stage_sharded_inputs,
    )

    initialize_distributed(f"127.0.0.1:{port}", num_processes=2,
                           process_id=rank, backend="gloo")
    mesh = make_device_mesh(2, device="cpu")
    reader = VisibilityReader(dataset)
    parts = reader.partition(CHUNKS["row_chunks"], CHUNKS["freq_chunks"])
    shards = {i: StokesIGridderInput.from_reader(parts[i])
              for i in mesh.addressable_shard_indices}
    kwargs = dict(mesh=mesh, sigma="auto")
    staging = stage_loaded_shards(
        shards, reader.num_data_rows * reader.num_channels, NUM_PIXELS,
        PIXEL_SIZE_ASEC, **kwargs)
    from_reader = stage_sharded_inputs(reader, NUM_PIXELS, PIXEL_SIZE_ASEC,
                                       **CHUNKS, **kwargs)

    handed = []
    raw = clean.hogbom_clean

    def capture(dirty, psf, **kw):
        handed.append((dirty.clone(), psf.clone()))
        return raw(dirty, psf, **kw)

    clean.hogbom_clean = capture
    try:
        op = ShardedOperator(staging, "replicated")
        step = build_sharded_major_cycle_step(op, **CLEAN)
        residual = op.dirty()
        model = torch.zeros((NUM_PIXELS, NUM_PIXELS))
        models, residuals = [], [residual]
        for _ in range(CYCLES):
            model, residual = step(model, residual)
            models.append(model)
            residuals.append(residual)
    finally:
        clean.hogbom_clean = raw
    loop_model, loop_residual, loop_psf = sharded_major_cycle_clean(
        reader, NUM_PIXELS, PIXEL_SIZE_ASEC, num_major=CYCLES, **CHUNKS,
        **kwargs, **CLEAN)
    np.savez(
        out, staged_equal=_staged_equal(staging, from_reader),
        sigma=staging.plans[0].sigma, psf=step.psf.numpy(),
        models=np.stack([m.numpy() for m in models]),
        residuals=np.stack([r.numpy() for r in residuals]),
        handed_dirty=np.stack([d.numpy() for d, _ in handed]),
        handed_psf=np.stack([p.numpy() for _, p in handed]),
        loop_model=loop_model, loop_residual=loop_residual,
        loop_psf=loop_psf)
    shutdown_distributed()


if __name__ == "__main__":
    main()
