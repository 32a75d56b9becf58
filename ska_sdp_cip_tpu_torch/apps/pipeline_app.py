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

``-d/--devices`` raises ``NotImplementedError``: the multi-device path
is still to be ported (ROADMAP.md, A9); ``-rc``/``-fc`` are parsed so
that command lines stay compatible. ``--profile-dir`` writes a
``torch.profiler`` trace (CPU and CUDA activities) of the invert as
``trace.json`` in that directory.

    python -m ska_sdp_cip_tpu_torch.apps.pipeline_app obs.vz img.npy \\
        -n 2048 -p 5.0 --clean 2 --algorithm multiscale --device cuda
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
        help="Path to the input visibility dataset (VZ directory)",
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
        help="Distribute over several devices: not yet available in the "
        "port (raises)",
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
        help="Number of frequency chunks (with -d)",
    )
    dist_group.add_argument(
        "--profile-dir",
        type=Path,
        default=None,
        help="Write a torch.profiler trace of the invert to this "
        "directory (trace.json)",
    )
    return parser


@contextlib.contextmanager
def _profiled(profile_dir: Path | None):
    """Trace the body with ``torch.profiler`` (CPU and CUDA activities)
    into ``profile_dir/trace.json``; no trace when ``profile_dir`` is
    None."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        yield
    profile_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(profile_dir / "trace.json"))


def run_program(cli_args: list[str]) -> None:
    """Run the app; the function called by the tests."""
    args = get_parser().parse_args(cli_args)
    if args.devices is not None:
        raise NotImplementedError(
            f"-d/--devices {args.devices}: the multi-device path is still "
            "to be ported (ROADMAP.md, A9); run on one device"
        )
    device = resolve_device(args.device)
    reader = VisibilityReader(args.dataset)
    sigma = args.sigma if args.sigma == "auto" else float(args.sigma)

    with _profiled(args.profile_dir):
        image = invert_dataset(
            reader,
            num_pixels=args.num_pixels,
            pixel_size_asec=args.pixel_size,
            epsilon=args.epsilon,
            do_wstacking=not args.no_wstacking,
            weighting=args.weighting,
            robust=args.robust,
            sigma=sigma,
            device=device,
        )

    np.save(args.output_image.with_suffix(".npy"), image)

    if args.clean > 0:
        from ..invert import StokesIGridderInput, pixel_size_lm_from_asec
        from ..models import MeasurementOperator, major_cycle_clean
        from ..models.restore import restore_image

        gridder_input = StokesIGridderInput.from_reader(reader)
        weights = gridder_input.effective_weights()
        if args.weighting != "natural":
            # The model/residual must be consistent with the weighting
            # used for the dirty image above.
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
        vis = gridder_input.visibilities.ravel()
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
            model, residual = major_cycle_clean(
                operator,
                vis,
                num_major=args.clean,
                gain=args.gain,
                minor_iter=args.minor_iter,
                checkpoint_dir=args.checkpoint_dir,
            )
        psf = operator.psf()
        base = args.output_image.with_suffix("")
        # Every solver returns tensors on the operator's device.
        np.save(base.with_suffix(".model.npy"), model.cpu().numpy())
        np.save(base.with_suffix(".residual.npy"), residual.cpu().numpy())
        restored = restore_image(model, residual, psf, device=device)
        np.save(base.with_suffix(".restored.npy"), restored)


def main() -> None:
    """Entry point for the pipeline app."""
    run_program(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
