"""
Launcher of the multi-device imaging run: the ``torchrun`` recipe that
takes the place of ``deploy/tpu_pod_launch.sh``.

    python -m ska_sdp_cip_tpu_torch.parallel.launch --nproc-per-node 4 \\
        -- obs.vz img.npy -n 10240 -p 1.1 -d all --clean 3

starts ``torchrun --standalone --nproc-per-node 4 -m
ska_sdp_cip_tpu_torch.parallel.launch ...``, whose ranks each run
``tpu-cip-torch`` (``apps/pipeline_app.py``) with the arguments after
``--`` on ``cuda:LOCAL_RANK``. As in the JAX package's launcher, a run
with ``--clean`` checkpoints every major cycle (``--checkpoint-dir``,
by default ``<output>.ckpt`` beside the output) and a failed run (a
preempted or lost rank) is started again up to ``--max-retries`` times,
resuming CLEAN from the last completed cycle. ``--fft-mode
distributed`` splits every plane transform over the shards.

A process started with ``--coordinator HOST:PORT --num-processes N
--process-id I`` runs as rank I of that world itself, without
``torchrun`` (as a rank that ``torchrun`` started does, from its
environment).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

MODULE = "ska_sdp_cip_tpu_torch.parallel.launch"

#: Seconds between a failed run and the next (the JAX package's
#: launcher waits as long).
RETRY_WAIT_S = 30.0


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=f"python -m {MODULE}",
        description="Run tpu-cip-torch over several processes (torchrun), "
        "retrying after a failure; the arguments after -- go to "
        "tpu-cip-torch.",
    )
    parser.add_argument("--nproc-per-node", type=int, default=1,
                        help="Ranks to start (one per card)")
    parser.add_argument("--max-retries", type=int, default=3,
                        help="Runs to start before giving up")
    parser.add_argument("--fft-mode", choices=["replicated", "distributed"],
                        default="replicated",
                        help="distributed: split each plane's transforms "
                        "over the shards (needs -d)")
    parser.add_argument("--coordinator", default=None,
                        help="HOST:PORT of an explicit world: run this "
                        "process as one of its ranks")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("app_args", nargs=argparse.REMAINDER,
                        help="-- then the tpu-cip-torch arguments")
    return parser


def _app_args(args) -> list:
    app_args = list(args.app_args)
    if app_args[:1] == ["--"]:
        app_args = app_args[1:]
    return app_args


def run_rank(args) -> None:
    """This process as one rank: join the world, run the app."""
    from ..apps import pipeline_app
    from .mesh import (
        backend_for,
        initialize_distributed,
        local_device,
        shutdown_distributed,
    )

    app_args = _app_args(args)
    parsed = pipeline_app.get_parser().parse_args(app_args)
    initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        backend=backend_for(local_device(parsed.device)),
    )
    try:
        pipeline_app.run_program(app_args, fft_mode=args.fft_mode)
    finally:
        shutdown_distributed()


def with_checkpoint_dir(app_args: list) -> list:
    """``app_args`` plus ``--checkpoint-dir <output>.ckpt`` for a run
    with ``--clean`` that names none."""
    from ..apps import pipeline_app

    parsed = pipeline_app.get_parser().parse_args(app_args)
    if parsed.clean > 0 and parsed.checkpoint_dir is None:
        return app_args + ["--checkpoint-dir",
                           str(parsed.output_image.with_suffix(".ckpt"))]
    return app_args


def supervise(args) -> int:
    """Start the ranks under ``torchrun``; start them again after a
    failure, up to ``--max-retries`` runs. Returns the last exit code."""
    app_args = with_checkpoint_dir(_app_args(args))
    command = [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", str(args.nproc_per_node), "-m", MODULE,
        "--fft-mode", args.fft_mode, "--", *app_args,
    ]
    code = 1
    for attempt in range(1, args.max_retries + 1):
        code = subprocess.call(command)
        if code == 0:
            return 0
        print(f"launch: run {attempt} of {args.max_retries} failed "
              f"(exit {code})", file=sys.stderr, flush=True)
        if attempt < args.max_retries:
            time.sleep(RETRY_WAIT_S)
    return code


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    if args.coordinator is not None or "RANK" in os.environ:
        run_rank(args)
        return 0
    return supervise(args)


if __name__ == "__main__":
    sys.exit(main())
