"""
Balanced chunking of index ranges.

Counterpart: ``ska_sdp_cip_tpu/utils/chunking.py``, copied verbatim
(the port cannot import the JAX package).

Same semantics as the reference's chunking utilities
(reference: src/ska_sdp_cip/measurement_set.py:361-391): dividing ``n``
elements into ``k`` chunks yields ``n % k`` chunks of size ``n // k + 1``
followed by chunks of size ``n // k``.

These bounds are the framework's "sharding spec" on the host side: the
returned ``(start, end)`` pairs are what gets mapped onto mesh axes.
"""

from __future__ import annotations

from typing import Iterator


def balanced_chunk_sizes(n: int, k: int) -> Iterator[int]:
    """
    Yield the sizes of ``k`` chunks that partition a population of size
    ``n`` as evenly as possible (larger chunks first).
    """
    if not n > 0:
        raise ValueError("n must be > 0")
    if not 0 < k <= n:
        raise ValueError("k must be > 0 and <= n")

    quotient, remainder = divmod(n, k)
    for i in range(k):
        yield quotient + 1 if i < remainder else quotient


def balanced_chunk_bounds(
    start: int, end: int, k: int
) -> Iterator[tuple[int, int]]:
    """
    Yield ``(start, end)`` bounds of ``k`` balanced chunks covering the
    index range ``[start, end)``.
    """
    cursor = start
    for size in balanced_chunk_sizes(end - start, k):
        yield cursor, cursor + size
        cursor += size
