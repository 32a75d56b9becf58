"""
Pre-faulted host buffers for large planner outputs.

Counterpart: ``ska_sdp_cip_tpu/utils/hostmem.py:alloc_populated``,
copied with the helpers it needs. The glibc ``mallopt`` tuning of the
original (``enable_malloc_reuse``) is not carried: it is a
process-wide side effect of importing the JAX package that the port
does not repeat.
"""

from __future__ import annotations

import mmap as _mmap
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: Concurrent fault streams for :func:`alloc_populated`.
_TOUCH_WORKERS = 8
_touch_pool = None

#: Arena of already-faulted buffers, keyed by power-of-two bucket size;
#: buffers return here when their numpy array is garbage-collected.
_arena: dict = {}
_arena_lock = threading.Lock()


def _get_touch_pool():
    global _touch_pool
    if _touch_pool is None:
        _touch_pool = ThreadPoolExecutor(_TOUCH_WORKERS)
    return _touch_pool


def _arena_release(buf, bucket: int) -> None:
    with _arena_lock:
        _arena.setdefault(bucket, []).append(buf)


def alloc_populated(count: int, dtype) -> np.ndarray:
    """
    A fresh zeroed 1-D numpy array of ``count`` elements backed by
    pre-faulted anonymous memory (faulted by concurrent touch threads),
    or served zeroed from the warm-buffer arena when a freed buffer of
    the right bucket exists. Below 1 MiB this is ``np.empty``.
    """
    nbytes = int(count) * np.dtype(dtype).itemsize
    if nbytes < 1 << 20:
        return np.empty(int(count), dtype)
    bucket = 1 << (nbytes - 1).bit_length()
    pool = _get_touch_pool()
    with _arena_lock:
        free = _arena.get(bucket)
        buf = free.pop() if free else None
    if buf is not None:
        arr = np.frombuffer(buf, dtype=dtype, count=int(count))
        arr.flags.writeable = True
        zv = np.frombuffer(buf, dtype=np.uint8, count=nbytes)
        zv.flags.writeable = True
        chunk = -(-nbytes // _TOUCH_WORKERS)

        def _zero(start):
            zv[start : start + chunk] = 0

        list(pool.map(_zero, range(0, nbytes, chunk)))
        weakref.finalize(arr, _arena_release, buf, bucket)
        return arr
    try:
        buf = _mmap.mmap(
            -1, bucket, flags=_mmap.MAP_PRIVATE | _mmap.MAP_ANONYMOUS
        )
    except (AttributeError, OSError, ValueError):
        return np.empty(int(count), dtype)
    arr = np.frombuffer(buf, dtype=dtype, count=int(count))
    arr.flags.writeable = True
    touch = np.frombuffer(buf, dtype=np.uint8)
    touch.flags.writeable = True
    chunk = -(-nbytes // (2 * _TOUCH_WORKERS))

    def _touch(start):
        touch[start : start + chunk : _mmap.PAGESIZE] = 0

    list(pool.map(_touch, range(0, nbytes, chunk)))
    weakref.finalize(arr, _arena_release, buf, bucket)
    return arr
