"""
Process-group bring-up and the shard mesh of the multi-device path.

Counterpart: ``ska_sdp_cip_tpu/parallel/mesh.py`` (``initialize_distributed``,
``make_device_mesh``) and the host allgathers of
``ska_sdp_cip_tpu/parallel/sharded_invert.py`` (``addressable_shard_indices``,
``_allgather_max``, ``_allgather_sum``).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh`` of
S devices, and a process addresses the shards whose devices it holds.
Here a world of R ranks (``torch.distributed``: NCCL for CUDA tensors,
gloo for host tensors) carries a mesh of S shards, S a multiple of R:
rank r holds the contiguous shards r S/R ... (r + 1) S/R - 1, all on its
one device, and runs them eagerly one after the other. A collective
acts on the rank's list of per-shard tensors in two halves: the local
half as tensor ops on the device, the cross-rank half through the
process group. So S = 4 shards on one card run every collective of a
4-device mesh, as the JAX package's 8 virtual CPU devices do in one
process.

NCCL and gloo split the leading dimension of a contiguous tensor, so
every collective here scatters, exchanges and gathers along dimension
0; the callers lay out their slabs to match (``ops/gridder.py``).
"""

from __future__ import annotations

import os
import socket
from contextlib import contextmanager
from dataclasses import dataclass, field
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..utils.staging import resolve_device
from ..utils.task_metrics import count, span

#: Seconds a rank waits for the others to join (and for a collective)
#: before it raises.
TIMEOUT_S = 300.0


def backend_for(device) -> str:
    """
    The process-group backend for a world whose device tensors lie on
    ``device``: NCCL for CUDA tensors with gloo for the host
    collectives (``"cpu:gloo,cuda:nccl"``), gloo alone on the CPU.
    """
    return "cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda" \
        else "gloo"


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> None:
    """
    Join the process group (``torch.distributed.init_process_group``);
    nothing happens when it is already up.

    * ``coordinator_address`` ``"host:port"`` with ``num_processes`` and
      ``process_id``: an explicit world, joined over TCP; a failure to
      join raises;
    * else, where ``torchrun`` set ``RANK``, ``WORLD_SIZE`` and
      ``MASTER_ADDR``, the world it describes (``env://``);
    * else a world of one, over a TCP store on a free loopback port.

    ``backend`` defaults to :func:`backend_for` the card when there is
    one (``"cpu:gloo,cuda:nccl"``), else ``"gloo"``.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = backend_for("cuda" if torch.cuda.is_available() else "cpu")
    kwargs = {"backend": backend, "timeout": timedelta(seconds=TIMEOUT_S)}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes "
                             "and process_id")
        if not 0 <= int(process_id) < int(num_processes):
            raise ValueError(f"process_id {process_id} is not in "
                             f"[0, {num_processes})")
        dist.init_process_group(
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id), **kwargs)
    elif all(key in os.environ for key in ("RANK", "WORLD_SIZE",
                                           "MASTER_ADDR")):
        dist.init_process_group(init_method="env://", **kwargs)
    else:
        dist.init_process_group(
            init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
            rank=0, **kwargs)


def shutdown_distributed() -> None:
    """Leave the process group, if one is up (before the process exits,
    so its backends stop their threads in order)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_device(device) -> torch.device:
    """
    This rank's device for ``device``: a bare ``"cuda"`` under
    ``torchrun`` means ``cuda:LOCAL_RANK``; anything else is returned
    as it is.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def _reduce_scatter(output, tensor) -> None:
    """``reduce_scatter_single`` where torch has it (it deprecates
    ``reduce_scatter_tensor``), else ``reduce_scatter_tensor``."""
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(output, tensor)


def _all_gather(output, tensor) -> None:
    """``all_gather_single`` where torch has it, else
    ``all_gather_into_tensor``."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(output, tensor)


@dataclass
class CollectiveStats:
    """Calls and bytes of a mesh's collectives, by kind, always counted;
    and, while the span recorder is on (``utils/task_metrics.py``), each
    call's span ``collective.<kind>`` (two events on the current stream
    on a card, the host clock otherwise), read when
    :meth:`DeviceMesh.collective_stats` is asked."""

    calls: dict = field(default_factory=dict)
    bytes: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)


class DeviceMesh:
    """
    A 1-D mesh of ``num_shards`` shards over the ranks of the default
    process group, on this rank's ``device``. Build it with
    :func:`make_device_mesh`.

    The collectives take this rank's list of per-shard tensors (one per
    :attr:`addressable_shard_indices`, or any number of partial sums
    where the result is a sum) and return this rank's results. Every
    rank must call them in the same order with tensors of one shape.
    """

    def __init__(self, num_shards: int, device):
        self.device = torch.device(device)
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        if num_shards < 1 or num_shards % self.world_size:
            raise ValueError(
                f"{num_shards} shards do not divide over "
                f"{self.world_size} ranks"
            )
        self.num_shards = int(num_shards)
        self.stats = CollectiveStats()

    @property
    def local_shards(self) -> int:
        """Shards each rank holds (S / R)."""
        return self.num_shards // self.world_size

    @property
    def addressable_shard_indices(self) -> list:
        """This rank's shards: r S/R ... (r + 1) S/R - 1."""
        first = self.rank * self.local_shards
        return list(range(first, first + self.local_shards))

    def __repr__(self) -> str:
        return (f"DeviceMesh(num_shards={self.num_shards}, "
                f"rank={self.rank}/{self.world_size}, device={self.device})")

    # --- timing ------------------------------------------------------

    @contextmanager
    def _timed(self, kind: str, nbytes: int, host: bool = False):
        """Count one collective of ``kind`` moving ``nbytes``; while the
        recorder is on, record it as a span, a device span on the card
        unless it is a ``host`` collective."""
        stats = self.stats
        stats.calls[kind] = stats.calls.get(kind, 0) + 1
        stats.bytes[kind] = stats.bytes.get(kind, 0) + int(nbytes)
        with span("collective." + kind,
                  device=self.device.type == "cuda" and not host) as record:
            yield
        if record is not None:
            count(record.name + ".calls")
            count(record.name + ".bytes", nbytes)
            stats.spans.append((kind, record))

    def reset_stats(self) -> None:
        self.stats = CollectiveStats()

    def collective_stats(self) -> dict:
        """``{"calls", "bytes", "seconds"}`` by kind since the last
        :meth:`reset_stats`, and ``total_seconds``. Seconds are those of
        the collectives made while the span recorder was on (after the
        card's pending work, which this waits for)."""
        stats = self.stats
        if stats.spans and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = {}
        for kind, record in stats.spans:
            spent = record.device_s if record.device else record.host_s
            seconds[kind] = seconds.get(kind, 0.0) + spent
        return {"calls": dict(stats.calls), "bytes": dict(stats.bytes),
                "seconds": seconds,
                "total_seconds": float(sum(seconds.values()))}

    # --- device collectives ------------------------------------------

    def _check(self, tensors, what: str) -> list:
        tensors = list(tensors)
        if len(tensors) != self.local_shards:
            raise ValueError(f"{what} takes one tensor per local shard "
                             f"({self.local_shards}), got {len(tensors)}")
        return tensors

    @staticmethod
    def _local_sum(tensors) -> torch.Tensor:
        """The sum of ``tensors``: the tensor itself when there is one."""
        total = tensors[0]
        for t in tensors[1:]:
            total = total + t
        return total

    def psum(self, tensors) -> torch.Tensor:
        """The sum over every shard of the mesh: the local partial sums
        ``tensors`` added on the device, then ``all_reduce`` (in place: a
        single tensor given is overwritten with the sum)."""
        total = self._local_sum(list(tensors))
        with self._timed("all_reduce", total.numel() * total.element_size()):
            dist.all_reduce(total)
        return total

    def psum_scatter(self, tensors) -> list:
        """
        The sum over every shard, scattered along dimension 0: the local
        partial sums added, ``reduce_scatter`` into R rank slabs, and the
        rank's slab split into its S/R shard slabs (views, in shard
        order). Dimension 0 must divide by S.
        """
        total = self._local_sum(list(tensors))
        rows = total.shape[0]
        if rows % self.num_shards:
            raise ValueError(f"dimension 0 ({rows}) does not divide by "
                             f"{self.num_shards} shards")
        out = total.new_empty((rows // self.world_size,) + total.shape[1:])
        with self._timed("reduce_scatter",
                         total.numel() * total.element_size()):
            _reduce_scatter(out, total.contiguous())
        return list(out.chunk(self.local_shards, dim=0))

    def all_to_all(self, tensors) -> list:
        """
        The tiled all-to-all of the mesh along dimension 0: each local
        shard's tensor (S c, ...) is cut into S chunks, chunk j going to
        shard j. Returns, per local shard, an (S, c, ...) tensor of the
        chunks it received, in source-shard order.
        """
        tensors = self._check(tensors, "all_to_all")
        S, R, L = self.num_shards, self.world_size, self.local_shards
        rows = tensors[0].shape[0]
        if rows % S:
            raise ValueError(f"dimension 0 ({rows}) does not divide by "
                             f"{S} shards")
        tail = tuple(tensors[0].shape[1:])
        c = rows // S
        # (L_src, R_dst, L_dst, c, ...) -> (R_dst, L_src, L_dst, c, ...):
        # each destination rank's block contiguous.
        send = torch.stack(tensors).reshape((L, R, L, c) + tail)
        send = send.transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        with self._timed("all_to_all", send.numel() * send.element_size()):
            dist.all_to_all_single(recv, send)
        # recv: (R_src, L_src, L_dst, c, ...) = (S_src, L_dst, c, ...).
        recv = recv.reshape((S, L, c) + tail)
        return [recv[:, j] for j in range(L)]

    def all_gather(self, tensors) -> torch.Tensor:
        """Every shard's tensor, stacked in shard order: (S, ...)."""
        tensors = self._check(tensors, "all_gather")
        local = torch.stack(tensors)
        out = local.new_empty((self.num_shards,) + tuple(local.shape[1:]))
        with self._timed("all_gather", local.numel() * local.element_size()):
            _all_gather(out, local)
        return out

    # --- host collectives (small numpy arrays, through gloo) -----------

    def _host_gather(self, values) -> np.ndarray:
        """Every rank's ``values`` (int64 or float64), stacked: (R, ...).
        Runs through the group's gloo backend even in a world of one."""
        values = np.asarray(values)
        dtype = np.int64 if np.issubdtype(values.dtype, np.integer) \
            else np.float64
        local = torch.from_numpy(np.ascontiguousarray(values, dtype)
                                 .reshape(-1))
        out = local.new_empty(self.world_size * local.numel())
        with self._timed("host_allgather", local.numel() * 8, host=True):
            _all_gather(out, local)
        return out.numpy().reshape((self.world_size,) + values.shape)

    def allgather_max(self, values) -> np.ndarray:
        """Element-wise max of a small host array over the ranks."""
        return self._host_gather(values).max(axis=0)

    def allgather_sum(self, values) -> np.ndarray:
        """Element-wise sum of a host array over the ranks."""
        return self._host_gather(values).sum(axis=0)


def make_device_mesh(num_shards: int | None = None, *, device) -> DeviceMesh:
    """
    The mesh of ``num_shards`` shards (default: one per rank) over the
    default process group, on this rank's ``device``
    (:func:`local_device`). Starts a world of one when no group is up
    (:func:`initialize_distributed`). Raises unless the world size
    divides ``num_shards``.
    """
    device = resolve_device(local_device(device))
    if not dist.is_initialized():
        initialize_distributed(backend=backend_for(device))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if num_shards is None:
        num_shards = dist.get_world_size()
    return DeviceMesh(int(num_shards), device)
