"""
The scale frames of a multiscale minor cycle on the card: kernel S1
(``csrc/scale_conv.cu``).

Counterpart: none; the JAX package convolves with XLA
(``ska_sdp_cip_tpu/models/multiscale.py:_conv_same``). The plain version
of S1 is the port's ``models/multiscale.py:_separable_frames_reference``
(the same two passes as ``conv2d`` with (1, k) and (k, 1) kernels), which
``_separable_frames`` runs on CPU tensors; it calls :func:`scale_frames`
for CUDA tensors: nothing falls back from one to the other.

S1 writes an image's S frames, each the image convolved with
``f_s (x) f_s`` in a zero margin of ``pad`` cells, in one launch: a row
pass and a column pass of each factor over a tile staged once in shared
memory, every frame cell (the margins too) written once.
"""

from __future__ import annotations

import torch

from ..utils.task_metrics import count

#: Calls of :func:`scale_frames` (one launch each). Callers reset it to 0
#: and read it to show that a run went through the kernel.
SCALE_CONV_LAUNCHES = 0

#: Most scales S1 takes (``csrc/scale_conv.cu:kMaxScales``).
MAX_SCALES = 8

#: Outputs a thread of S1 keeps in registers (``kValues``): the taps are
#: zero-padded to a multiple of it.
VALUES = 8

#: Shared memory a block may take on an H100 (227 KB, opted in).
SHARED_LIMIT = 232448


def _quad_odd(n: int) -> int:
    """The least multiple of 4 >= n that is not a multiple of 8."""
    m = -(-n // 4) * 4
    return m if m % 8 else m + 4


def shared_bytes(tile: int, ksize: int, num_scales: int) -> int:
    """S1's shared memory a block (``csrc/scale_conv.cu:shared_bytes``):
    the radii, the taps, the staged input square and the row pass's
    intermediate."""
    taps = -(-ksize // VALUES) * VALUES
    extent = tile + 2 * (ksize // 2) + VALUES
    return 4 * (MAX_SCALES + num_scales * taps + extent * (extent | 1)
                + tile * _quad_odd(tile + taps))


def pick_tile(ksize: int, num_scales: int) -> int:
    """The output tile (64, else 32 cells a side) whose block fits in
    :data:`SHARED_LIMIT` (64 up to 135 taps at 8 scales); ValueError if
    neither does (above 183 taps at 8 scales)."""
    for tile in (64, 32):
        if shared_bytes(tile, ksize, num_scales) <= SHARED_LIMIT:
            return tile
    raise ValueError(f"a {ksize}-tap factor does not fit S1's shared memory "
                     f"({shared_bytes(32, ksize, num_scales)} bytes a block "
                     f"at the smallest tile, {SHARED_LIMIT} allowed)")


def scale_frames(image: torch.Tensor, factors: torch.Tensor,
                 pad: int) -> torch.Tensor:
    """
    ``(S, rows + 2 pad, cols + 2 pad)`` float32 frames on the card of
    ``image``: frame s is ``image`` (rows, cols; float32) convolved with
    ``factors[s] (x) factors[s]`` (factors: (S, ksize) float32, ksize
    odd), SAME and zero-padded, inside a zero margin of ``pad`` cells.
    """
    global SCALE_CONV_LAUNCHES
    from . import _build

    if image.dtype != torch.float32 or image.dim() != 2:
        raise TypeError("image must be a float32 matrix")
    if factors.dtype != torch.float32 or factors.dim() != 2:
        raise TypeError("factors must be a float32 (S, ksize) matrix")
    num_scales, ksize = factors.shape
    if not 1 <= num_scales <= MAX_SCALES:
        raise ValueError(f"{num_scales} scales; S1 takes 1 to {MAX_SCALES}")
    if ksize % 2 == 0:
        raise ValueError(f"factors of {ksize} taps; S1 takes an odd count")
    if pad < 0:
        raise ValueError(f"pad must be >= 0, not {pad}")
    tile = pick_tile(ksize, num_scales)
    if image.device.type != "cuda":
        raise ValueError(f"S1 runs on a CUDA device, not {image.device}")
    if factors.device != image.device:
        raise ValueError("image and factors must be on one device")
    image, factors = image.contiguous(), factors.contiguous()
    rows, cols = image.shape
    frames = torch.empty((num_scales, rows + 2 * pad, cols + 2 * pad),
                         dtype=torch.float32, device=image.device)
    lib = _build.load_library()
    err = lib.cip_scale_conv(
        image.data_ptr(), factors.data_ptr(), frames.data_ptr(), int(rows),
        int(cols), int(num_scales), int(ksize), int(pad), tile,
        torch.cuda.current_stream(image.device).cuda_stream,
    )
    _build.check(err, "cip_scale_conv")
    SCALE_CONV_LAUNCHES += 1
    count("scale_conv_kernel", 1)
    return frames
