"""
Ingest CLI — the ``tpu-cip-ingest-torch`` entry point.

Counterpart: ``ska_sdp_cip_tpu/apps/ingest_app.py`` (``tpu-cip-ingest``),
with the same arguments: ``ms``, ``vz``, ``--row-block`` and
``--version``. One-shot MSv2 -> VZ conversion (``io/ms_ingest.py``)
through python-casacore where it is importable, else through the
casacore-free reader (``io/casacore_tables.py``). It touches no card, so
it has no ``--device``.

    tpu-cip-ingest-torch obs.ms obs.vz --row-block 100000
"""

import argparse
import sys
from pathlib import Path

from .. import __version__


def get_parser() -> argparse.ArgumentParser:
    """Create the CLI parser for the app."""
    parser = argparse.ArgumentParser(
        description=(
            "Convert a MeasurementSet v2 into the native VZ columnar "
            "store (python-casacore if installed, else the casacore-free "
            "reader)"
        ),
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument(
        "ms", type=Path, help="Path to the input MeasurementSet v2"
    )
    parser.add_argument(
        "vz", type=Path, help="Path for the output VZ dataset directory"
    )
    parser.add_argument(
        "--row-block",
        type=int,
        default=1_000_000,
        help="Rows converted per streaming block (bounds memory)",
    )
    return parser


def run_program(cli_args: list) -> None:
    """Run the app; the function called by the tests."""
    args = get_parser().parse_args(cli_args)
    from ..io.ms_ingest import ms_to_vz

    path = ms_to_vz(args.ms, args.vz, row_block=args.row_block)
    print(f"wrote {path}")


def main() -> None:
    """Entry point for the ingest app."""
    run_program(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
