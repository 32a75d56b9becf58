"""
Imaging CLI — the ``tpu-cip-torch`` entry point.

Counterpart: ``ska_sdp_cip_tpu/apps/pipeline_app.py`` (``tpu-cip``).
Every option of the counterpart keeps its name, default, choices and
``nargs``, so a ``tpu-cip`` command line runs here as it is, on the
device that ``--device`` names (the one option added; default
``cuda``, which needs a card: nothing falls back to the CPU). Positional
dataset + output image, ``-n/--num-pixels``, ``-p/--pixel-size``,
weighting, and ``--clean N`` with the Hogbom/Clark, multiscale or FISTA
solver, writing ``<output>.model.npy``, ``.residual.npy`` and
``.restored.npy`` beside the dirty image.

``-d/--devices N|all`` runs the invert, and ``--clean N``, over a mesh
of N shards (``all``: one per rank) with ``-rc``/``-fc`` row and
frequency chunks (``parallel/``), and writes ``task-list.json`` in the
reference's schema. It joins the process group that ``torchrun`` sets
up (each rank on ``cuda:LOCAL_RANK``), or runs as a world of one whose
shards share the device; only rank 0 writes files. ``--profile-dir``
writes a ``torch.profiler`` trace (CPU and CUDA activities) of the
invert as ``trace.json`` in that directory, with the program's
``cip.*`` span ranges beside the kernels, and the spans and counters
themselves (``utils/task_metrics.py``) as ``spans.json``.

    python -m ska_sdp_cip_tpu_torch.apps.pipeline_app obs.vz img.npy \\
        -n 2048 -p 5.0 --clean 2 --algorithm multiscale --device cuda
    torchrun --standalone --nproc-per-node 4 \\
        -m ska_sdp_cip_tpu_torch.apps.pipeline_app obs.vz img.npy \\
        -n 10240 -p 1.1 -d all --clean 3 --checkpoint-dir ckpt
"""

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np

from .. import __version__
from ..invert import invert_dataset
from ..io.visibility_dataset import VisibilityReader
from ..ops.gridder import resolve_device
from ..utils import task_metrics
from ..utils.task_metrics import TaskRecorder


def get_parser() -> argparse.ArgumentParser:
    """Create the CLI parser for the app."""
    parser = argparse.ArgumentParser(
        description="Launch the SKA continuum imaging pipeline on a CUDA "
        "card (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument(
        "dataset",
        type=Path,
        help="Path to the input visibility dataset (VZ directory, or "
        "MeasurementSet v2)",
    )
    parser.add_argument(
        "output_image",
        type=Path,
        help="Path to output image, which is saved as a numpy array",
    )
    parser.add_argument(
        "--device",
        type=str,
        default="cuda",
        help='Torch device to run on ("cuda", "cuda:1", or "cpu" for the '
        "kernels' plain versions)",
    )

    imaging_group = parser.add_argument_group("imaging")
    imaging_group.add_argument(
        "-n",
        "--num-pixels",
        type=int,
        required=True,
        help="Number of pixels across the image",
    )
    imaging_group.add_argument(
        "-p",
        "--pixel-size",
        type=float,
        required=True,
        help="Pixel size in arcseconds at the image centre",
    )
    imaging_group.add_argument(
        "-e",
        "--epsilon",
        type=float,
        default=1e-4,
        help="Gridding accuracy target",
    )
    imaging_group.add_argument(
        "--no-wstacking",
        action="store_true",
        help="Disable w-stacking (narrow-field imaging)",
    )
    imaging_group.add_argument(
        "--sigma",
        type=str,
        default="auto",
        help='uv-grid oversampling factor (e.g. 2.0, 1.5), or "auto": '
        "cost-model choice — FFT-dominated wide fields get 1.5 (44%% "
        "smaller padded grid per w-plane), visibility-dominated runs "
        "keep 2.0",
    )
    imaging_group.add_argument(
        "--weighting",
        choices=["natural", "uniform", "robust"],
        default="natural",
        help="Imaging weighting scheme",
    )
    imaging_group.add_argument(
        "--robust",
        type=float,
        default=0.0,
        help="Briggs robustness parameter (with --weighting robust)",
    )

    clean_group = parser.add_argument_group("deconvolution")
    clean_group.add_argument(
        "--clean",
        type=int,
        default=0,
        metavar="N",
        help="Run N CLEAN major cycles after the dirty image; writes "
        "<output>.model.npy, <output>.residual.npy and "
        "<output>.restored.npy",
    )
    clean_group.add_argument(
        "--algorithm",
        choices=["hogbom", "multiscale", "fista"],
        default="hogbom",
        help="Deconvolution algorithm for --clean (fista runs "
        "N * minor-iter / 10 iterations)",
    )
    clean_group.add_argument(
        "--scales",
        type=float,
        nargs="+",
        default=[0.0, 2.0, 4.0, 8.0],
        help="Scale sizes in pixels (with --algorithm multiscale)",
    )
    clean_group.add_argument(
        "--gain",
        type=float,
        default=0.1,
        help="CLEAN loop gain",
    )
    clean_group.add_argument(
        "--minor-iter",
        type=int,
        default=100,
        help="Hogbom iterations per major cycle",
    )
    clean_group.add_argument(
        "--checkpoint-dir",
        type=Path,
        default=None,
        help="Checkpoint/resume directory for the major cycle",
    )

    dist_group = parser.add_argument_group("distribution")
    dist_group.add_argument(
        "-d",
        "--devices",
        type=str,
        default=None,
        help="Number of shards to distribute over, or 'all' (one per "
        "rank of the torchrun world)",
    )
    dist_group.add_argument(
        "-rc",
        "--row-chunks",
        type=int,
        default=None,
        help="Number of row chunks (shards) along the row axis (with -d)",
    )
    dist_group.add_argument(
        "-fc",
        "--freq-chunks",
        type=int,
        default=None,
        help="Number of frequency chunks (with -d). If None, set to "
        "min(num_channels, num_shards).",
    )
    dist_group.add_argument(
        "--profile-dir",
        type=Path,
        default=None,
        help="Write a torch.profiler trace of the invert to this "
        "directory (trace.json), and its spans and counters (spans.json)",
    )
    return parser


@contextlib.contextmanager
def _profiled(profile_dir: Path | None):
    """Trace the body with ``torch.profiler`` (CPU and CUDA activities)
    into ``profile_dir/trace.json``, and its spans and counters into
    ``profile_dir/spans.json``; nothing when ``profile_dir`` is None."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    task_metrics.reset()
    with task_metrics.tracing(), profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        yield
    profile_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(profile_dir / "trace.json"))
    task_metrics.save_spans_json(profile_dir / "spans.json")


def _mesh(args):
    """The shard mesh of ``-d``: the process group joined (torchrun's, or
    a world of one), this rank's device, ``-d`` shards (``all``: one per
    rank)."""
    from ..parallel.mesh import (
        backend_for,
        initialize_distributed,
        local_device,
        make_device_mesh,
    )

    device = resolve_device(local_device(args.device))
    initialize_distributed(backend=backend_for(device))
    num_shards = None if args.devices == "all" else int(args.devices)
    return make_device_mesh(num_shards, device=device)


def _operator(args, reader, sigma, device):
    """The single-device measurement operator of ``--clean``, on the
    weights of the dirty image."""
    from ..invert import StokesIGridderInput, pixel_size_lm_from_asec
    from ..models import MeasurementOperator

    gridder_input = StokesIGridderInput.from_reader(reader)
    weights = gridder_input.effective_weights()
    if args.weighting != "natural":
        # The model/residual must be consistent with the weighting
        # used for the dirty image.
        from ..models.weighting import ImagingWeighter

        weighter = ImagingWeighter(
            args.num_pixels,
            pixel_size_lm_from_asec(args.pixel_size),
            scheme=args.weighting,
            robust=args.robust,
        ).fit(
            gridder_input.uvw,
            gridder_input.channel_frequencies,
            weights,
        )
        weights = weighter.apply(
            gridder_input.uvw,
            gridder_input.channel_frequencies,
            weights,
        )
    operator = MeasurementOperator.build(
        gridder_input.uvw,
        gridder_input.channel_frequencies,
        weights,
        args.num_pixels,
        pixel_size_lm_from_asec(args.pixel_size),
        epsilon=args.epsilon,
        do_wstacking=not args.no_wstacking,
        sigma=sigma,
        device=device,
    )
    return operator, gridder_input.visibilities.ravel()


def _clean(args, reader, sigma, device) -> tuple:
    """``--clean`` on one device: (model, residual, psf)."""
    operator, vis = _operator(args, reader, sigma, device)
    if args.algorithm == "multiscale":
        from ..models.multiscale import multiscale_clean

        model, residual = multiscale_clean(
            operator,
            vis,
            scales=tuple(args.scales),
            num_major=args.clean,
            gain=args.gain,
            minor_iter=args.minor_iter,
        )
    elif args.algorithm == "fista":
        from ..models.fista import fista_clean

        model, residual, _ = fista_clean(
            operator,
            vis,
            num_iter=args.clean * args.minor_iter // 10,
        )
    else:
        from ..models import major_cycle_clean

        model, residual = major_cycle_clean(
            operator,
            vis,
            num_major=args.clean,
            gain=args.gain,
            minor_iter=args.minor_iter,
            checkpoint_dir=args.checkpoint_dir,
        )
    # Every solver returns tensors on the operator's device.
    return model.cpu().numpy(), residual.cpu().numpy(), operator.psf()


def run_program(cli_args: list[str], *,
                fft_mode: str = "replicated") -> None:
    """Run the app; the function called by the tests. ``fft_mode`` is the
    sharded runs' (``-d``) plane-transform mode (``parallel/launch.py``
    passes ``--fft-mode``)."""
    args = get_parser().parse_args(cli_args)
    mesh = _mesh(args) if args.devices is not None else None
    device = mesh.device if mesh is not None else resolve_device(args.device)
    writer = mesh is None or mesh.rank == 0
    reader = VisibilityReader(args.dataset)
    sigma = args.sigma if args.sigma == "auto" else float(args.sigma)
    imaging = dict(
        epsilon=args.epsilon,
        do_wstacking=not args.no_wstacking,
        weighting=args.weighting,
        robust=args.robust,
        sigma=sigma,
    )

    # Pre-fault the planner's host allocation arenas (utils/hostmem.py):
    # this moves the cold page faults of the first plan to start-up.
    from ..ops.plan import prewarm_plan_arenas

    prewarm_plan_arenas(reader.num_data_rows * reader.num_channels)

    with _profiled(args.profile_dir if writer else None):
        if mesh is None:
            image = invert_dataset(
                reader,
                num_pixels=args.num_pixels,
                pixel_size_asec=args.pixel_size,
                device=device,
                **imaging,
            )
        else:
            from ..parallel.sharded_invert import sharded_invert_dataset

            recorder = TaskRecorder()
            image = sharded_invert_dataset(
                reader,
                num_pixels=args.num_pixels,
                pixel_size_asec=args.pixel_size,
                mesh=mesh,
                row_chunks=args.row_chunks,
                freq_chunks=args.freq_chunks,
                recorder=recorder,
                fft_mode=fft_mode,
                **imaging,
            )
            if writer:
                # Same file name / schema as the reference
                # (reference: apps/pipeline_app.py:105-107).
                recorder.save_json("task-list.json", indent=4,
                                   sort_keys=True)

    if writer:
        np.save(args.output_image.with_suffix(".npy"), image)

    if args.clean > 0:
        from ..models.restore import restore_image

        if mesh is None:
            model, residual, psf = _clean(args, reader, sigma, device)
        else:
            # The distributed major cycle over the same mesh; its PSF
            # comes from the sharded operator itself.
            from ..parallel.sharded_clean import sharded_major_cycle_clean

            model, residual, psf = sharded_major_cycle_clean(
                reader,
                args.num_pixels,
                args.pixel_size,
                mesh=mesh,
                row_chunks=args.row_chunks,
                freq_chunks=args.freq_chunks,
                num_major=args.clean,
                gain=args.gain,
                minor_iter=args.minor_iter,
                algorithm=args.algorithm,
                scales=tuple(args.scales),
                checkpoint_dir=args.checkpoint_dir,
                fft_mode=fft_mode,
                **imaging,
            )
        if writer:
            base = args.output_image.with_suffix("")
            np.save(base.with_suffix(".model.npy"), model)
            np.save(base.with_suffix(".residual.npy"), residual)
            restored = restore_image(model, residual, psf, device=device)
            np.save(base.with_suffix(".restored.npy"), restored)


def main() -> None:
    """Entry point for the pipeline app."""
    from ..parallel.mesh import shutdown_distributed

    try:
        run_program(sys.argv[1:])
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    sys.exit(main())
