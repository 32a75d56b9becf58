"""
The sharded cell's yardstick: the geometry its ranks plan, and the least
time and the seconds of its image psum.

The program resolves ``sigma="auto"`` for the whole mesh, from the
global visibility count and the global w range
(``parallel/sharded_invert.py:stage_loaded_shards``), so that every
shard grids the same grid; each shard then plans its planes over its own
w range (the replicated FFT mode). :func:`shard_geometries` resolves it
the same way with ``work.py``'s frozen cost model, where
``work.geometry(..., sigma="auto")`` on one shard would resolve the
shard's own count (sigma 1.5 and a 15360² grid in ``csd3-10k-4node``,
where the program grids 20480² at sigma 2.0).

The psum's least time: its bytes (``parallel/mesh.py``'s counter
``collective.all_reduce.bytes``) sent once and received once at NVLink
4's rate a direction on an H100 SXM. That is the traffic of an
in-switch reduction (NVLink SHARP: each card sends its buffer to the
switch once and reads the sum once), which no all-reduce algorithm beats
on that link (a ring moves 2 (R - 1) / R times the buffer each way), so
the share cannot pass 100% whichever NCCL picks. The psum's seconds are
those of the program's span ``collective.all_reduce``, a device span
(two CUDA events around it on the current stream, the wait for the last
rank included) where the mesh runs on a card, a host span on a CPU mesh.
"""

from __future__ import annotations

import numpy as np

from . import work
from .recorded import counter, span_seconds

#: The program's span and counter of the image psum (``parallel/mesh.py``).
PSUM_SPAN = "collective.all_reduce"
PSUM_BYTES = PSUM_SPAN + ".bytes"

#: Bytes a second in each direction of one H100 SXM's NVLink 4 (18
#: links of 25 GB/s a direction: NVIDIA's 900 GB/s, both directions
#: summed).
NVLINK_BYTES_PER_S = 450e9


def psum_least_seconds(nbytes: float) -> float:
    """Least seconds of all-reducing ``nbytes`` a card over NVLink."""
    return nbytes / NVLINK_BYTES_PER_S


def psum_seconds() -> float | None:
    """Seconds the recorder holds of the image psums: the device clock
    on a card, the host clock on a CPU mesh; None where it holds none."""
    seconds = span_seconds([PSUM_SPAN], "device_s")
    return seconds if seconds is not None else span_seconds([PSUM_SPAN],
                                                            "host_s")


def psum_bytes() -> int | None:
    """Bytes the recorder counted of the image psums."""
    return counter(PSUM_BYTES)


def resolve_sigma(num_visibilities: int, w_extent: float, npix: int,
                  pixel_size_lm: float, *, epsilon: float) -> float:
    """``work.geometry``'s sigma="auto" cost model, on the global count
    and the global w extent."""
    nm1_min = work.nm1_min_of(npix, pixel_size_lm)

    def cost(sigma: float) -> float:
        support = work.kernel_support_for_epsilon(epsilon, sigma)
        ngrid = work.next_even_grid_size(int(np.ceil(sigma * npix)))
        nplanes = work._planes(w_extent, nm1_min, sigma, support)
        return (num_visibilities * support
                * work.SIGMA_COST_GRID_PER_VIS_PLANE
                + nplanes * ngrid * ngrid
                * work.SIGMA_COST_FFT_PER_CELL_PLANE)

    return min(work.SIGMA_CANDIDATES, key=cost)


def shard_geometries(uvw, freqs, shard_freqs: list, npix: int,
                     pixel_size_lm: float, *, epsilon: float, sigma,
                     num_visibilities: int) -> list:
    """The ``work.Geometry`` of each shard (its channels ``shard_freqs``
    of the band ``freqs``, every row of ``uvw``), sigma resolved from
    ``num_visibilities`` and the band's w range."""
    if sigma == "auto":
        wmin, wmax = work.w_range(uvw, freqs)
        sigma = resolve_sigma(num_visibilities, wmax - wmin, npix,
                              pixel_size_lm, epsilon=epsilon)
    return [work.geometry(uvw, f, npix, pixel_size_lm, epsilon=epsilon,
                          sigma=sigma) for f in shard_freqs]
