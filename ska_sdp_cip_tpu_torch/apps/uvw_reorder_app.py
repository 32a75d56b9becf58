"""
UVW reorder CLI — the ``tpu-cip-reorder-uvw-torch`` entry point.

Counterpart: ``ska_sdp_cip_tpu/apps/uvw_reorder_app.py``
(``tpu-cip-reorder-uvw``), copied onto the port's reader, tiling
modules and task recorder: the same arguments (host-local worker count
``-j``, multi-host striding with its marker-file barrier between the
two passes, which runs on the host only), the same tile files, and
``task-list.json`` in the same schema. Reordering is host work; the
tiles it writes feed ``uvw_tiling/tiled_invert.py:invert_tile_chunks``
on the card:

    tpu-cip-reorder-uvw-torch obs.vz -t 10000 10000 20000 -o tiles/
"""

import argparse
import sys
from pathlib import Path

from .. import __version__
from ..io.visibility_dataset import VisibilityReader
from ..utils.task_metrics import TaskRecorder
from ..uvw_tiling import reorder_by_uvw_tile


def get_parser() -> argparse.ArgumentParser:
    """Create the CLI parser for the app."""
    parser = argparse.ArgumentParser(
        description=(
            "Convert visibilities to Stokes I and sort them by UVW tile"
        ),
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
        "-t",
        "--tile-size",
        nargs=3,
        type=float,
        required=True,
        help=(
            "UVW tile size in units of wavelength, as a space-separated "
            "sequence of 3 real-valued numbers"
        ),
    )
    parser.add_argument(
        "-o",
        "--outdir",
        type=Path,
        default=Path.cwd(),
        help=(
            "Output directory for the reordered data (and temporary "
            "files). Created if it does not exist."
        ),
    )
    parser.add_argument(
        "-n",
        "--num-time-intervals",
        type=int,
        default=None,
        help=(
            "Split the input data into this many time chunks. "
            "If None, a choice is made automatically."
        ),
    )
    parser.add_argument(
        "-m",
        "--max-vis-per-chunk",
        type=int,
        default=5_000_000,
        help="Maximum number of visibility samples per tile chunk file",
    )
    parser.add_argument(
        "-j",
        "--workers",
        type=int,
        default=None,
        help="Host-local worker processes (default: CPU count)",
    )
    parser.add_argument(
        "--num-hosts",
        type=int,
        default=1,
        help="Total hosts sharing the reorder over a common filesystem",
    )
    parser.add_argument(
        "--host-index",
        type=int,
        default=0,
        help="This host's index in [0, num_hosts)",
    )
    parser.add_argument(
        "--run-id",
        type=str,
        default=None,
        help=(
            "Label scoping the multi-host pass-1 barrier markers. Must "
            "be identical on every host of one launch and FRESH per "
            "launch (a stale marker from an earlier launch into the "
            "same outdir would release the barrier early). Default: "
            "$CIP_RUN_ID, then $SLURM_JOB_ID; with neither set, "
            "multi-host runs refuse to start without an explicit value"
        ),
    )
    return parser


def resolve_run_id(run_id, num_hosts: int) -> str:
    """
    Resolve the barrier run id: explicit flag, else a launch-scoped id
    every host agrees on ($CIP_RUN_ID, then the scheduler's job id).
    Refuses to fall back to a constant for multi-host runs — a
    colliding default is exactly the stale-marker footgun the round-1
    advisor warned about.
    """
    import os

    if run_id:
        return run_id
    for var in ("CIP_RUN_ID", "SLURM_JOB_ID"):
        value = os.environ.get(var)
        if value:
            return value
    if num_hosts > 1:
        raise SystemExit(
            "--run-id is required for multi-host reorder runs (or set "
            "CIP_RUN_ID identically on every host): barrier markers "
            "must be scoped to one launch"
        )
    return "run"


def run_program(cli_args: list) -> None:
    """Run the app; the function called by the tests."""
    args = get_parser().parse_args(cli_args)
    reader = VisibilityReader(args.dataset)

    outdir: Path = args.outdir
    outdir.mkdir(parents=True, exist_ok=True)

    recorder = TaskRecorder(worker=f"host{args.host_index}")
    if args.num_hosts == 1:
        with recorder.step("reorder_by_uvw_tile"):
            reorder_by_uvw_tile(
                reader,
                tuple(args.tile_size),
                outdir,
                num_time_intervals=args.num_time_intervals,
                max_vis_per_chunk=args.max_vis_per_chunk,
                max_workers=args.workers,
            )
    else:
        # Multi-host over a shared filesystem: pass 1, marker-file
        # barrier, pass 2 (the reference's inter-pass barrier,
        # reorder.py:87-90, done without a scheduler).
        import time

        from ..uvw_tiling.reorder import reorder_pass1, reorder_pass2

        run_id = resolve_run_id(args.run_id, args.num_hosts)

        def _marker(index: int) -> Path:
            return outdir / f"host{index}.pass1.{run_id}.done"

        # A marker left by a previous launch with the same run id can
        # release the barrier before the other hosts finish pass 1
        # (whose interval files pass 2 deletes). Each host can safely
        # clear only its OWN stale marker; distinct run ids protect
        # against the rest.
        _marker(args.host_index).unlink(missing_ok=True)

        with recorder.step("reorder_pass1"):
            reorder_pass1(
                reader,
                tuple(args.tile_size),
                outdir,
                num_time_intervals=args.num_time_intervals,
                max_workers=args.workers,
                num_hosts=args.num_hosts,
                host_index=args.host_index,
            )
            _marker(args.host_index).touch()

        with recorder.step("pass1_barrier"):
            deadline = time.time() + 86400
            while time.time() < deadline:
                done = sum(
                    _marker(index).exists()
                    for index in range(args.num_hosts)
                )
                if done >= args.num_hosts:
                    break
                time.sleep(2.0)
            else:
                raise TimeoutError("pass-1 barrier timed out")

        with recorder.step("reorder_pass2"):
            reorder_pass2(
                outdir,
                max_vis_per_chunk=args.max_vis_per_chunk,
                max_workers=args.workers,
                num_hosts=args.num_hosts,
                host_index=args.host_index,
            )
    recorder.save_json("task-list.json", indent=4, sort_keys=True)


def main() -> None:
    """Entry point for the reordering app."""
    run_program(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
