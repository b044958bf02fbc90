"""Device meshes for sharded video processing, in PyTorch.

Counterpart of :mod:`hsip_tpu.parallel.mesh`. The reference spreads frames
and videos over MPI ranks (``src/photron/parallel.py``); the JAX package
over the chips of a slice with a ``jax.sharding.Mesh``; here over the local
CUDA cards of ONE process:

* ``frame`` axis — the frames of one video split into contiguous shards,
  one a slot (the map phase is per frame; the differencing prior of each
  shard's first frame crosses from the left slot as a one-row halo,
  :mod:`.sharding`);
* ``video`` axis — whole videos split into contiguous shards, one a slot
  (each slot scans its own videos, serial-identical per video).

A :class:`Mesh` is a plain object: axis names, a shape, and an array of
*slots*, each holding a :class:`torch.device`. It is not
``torch.distributed.device_mesh.DeviceMesh``, which needs one process per
device and a collective backend: the JAX mesh is single-process SPMD, and
so is this one — the process launches each slot's work on that slot's
device, and since launches return at once, the device work of slots on
different cards overlaps. A device may fill several slots: the CPU tests
build 2-, 4- and 8-slot meshes on the CPU (the counterpart of JAX's virtual
CPU devices), and a one-card machine builds multi-slot meshes on
``cuda:0``. Slots that share a card share its memory and its stream.

Differences from the JAX module: :func:`frame_sharding` returns the split
of the frame axis over the slots (:class:`FrameSharding`), not a
``NamedSharding``; there is no ``P``: a shard is always a contiguous range
of the leading axis, and a sharded array is the list of its shards in slot
order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "FrameSharding", "make_mesh", "frame_sharding",
           "video_frame_mesh", "shard_bounds", "slot_shards"]


def _local_cards() -> List[torch.device]:
    from ..utils.backend import resolve_device

    resolve_device("cuda")  # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _as_devices(devices: Optional[Sequence]) -> List[torch.device]:
    """``devices`` resolved (``None``: the local cards). Each named device
    is checked as :func:`~hsip_tpu_torch.utils.backend.resolve_device`
    checks it; plain ``cuda`` becomes the current card."""
    from ..utils.backend import resolve_device

    if devices is None:
        return _local_cards()
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    return out


class Mesh:
    """An n-D array of device slots with named axes.

    ``devices`` is a numpy object array of :class:`torch.device` (one a
    slot), ``axis_names`` names its axes, ``shape`` maps each name to its
    size (as ``jax.sharding.Mesh.shape`` does) and ``size`` is the slot
    count. All slots are CUDA devices, or all the CPU.
    """

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device array for axes {axis_names}")
        if devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices.flat}) != 1:
            raise ValueError("a mesh's slots are all CUDA devices or all the CPU")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)

    def slots(self, axis_name: str) -> List[torch.device]:
        """The devices along ``axis_name``, in order, the other axes at
        index 0 (work that the JAX package replicates over the other axes
        runs once, on their first slots)."""
        if axis_name not in self.shape:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis_name!r} axis")
        axis = self.axis_names.index(axis_name)
        index = [0] * self.devices.ndim
        index[axis] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        shape = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({shape}; {', '.join(str(d) for d in self.devices.flat)})"


def make_mesh(
    axis_name: str = "frame",
    devices: Optional[Sequence] = None,
    n_devices: Optional[int] = None,
) -> Mesh:
    """1-D mesh over ``devices`` (``None``: the local CUDA cards), or their
    first ``n_devices``. ``devices`` may name a device more than once:
    each name is one slot."""
    devices = _as_devices(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh needs {n_devices} devices, found {len(devices)}"
            )
        devices = devices[:n_devices]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid, (axis_name,))


def video_frame_mesh(
    n_video_groups: int,
    devices: Optional[Sequence] = None,
    axis_names: Tuple[str, str] = ("video", "frame"),
) -> Mesh:
    """2-D mesh: ``n_video_groups`` video rows × frame columns.

    Videos are processed concurrently across rows; within a row, each
    video's frames shard across the columns.
    """
    devices = _as_devices(devices)
    n = len(devices)
    if n % n_video_groups:
        raise ValueError(
            f"{n} devices not divisible into {n_video_groups} video groups"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n_video_groups, n // n_video_groups), axis_names)


def shard_bounds(n: int, n_slots: int) -> List[Tuple[int, int]]:
    """The ``[start, stop)`` of each of ``n_slots`` contiguous shards of
    ``n`` rows, in slot order; the first ``n % n_slots`` one row longer."""
    q, r = divmod(int(n), int(n_slots))
    sizes = [q + (i < r) for i in range(n_slots)]
    starts = np.cumsum([0] + sizes[:-1])
    return [(int(a), int(a) + size) for a, size in zip(starts, sizes)]


def slot_shards(slots: Sequence[torch.device], n: int) -> List[Tuple[torch.device, List[int]]]:
    """The non-empty contiguous shards of ``n`` items over ``slots``, as
    ``(device, item indices)`` in slot order (none for a slot past ``n``)."""
    return [(slot, list(range(a, b)))
            for slot, (a, b) in zip(slots, shard_bounds(n, len(slots))) if b > a]


class FrameSharding:
    """The split of an (N, ...) batch's leading axis over ``slots``
    (:func:`shard_bounds`)."""

    def __init__(self, slots: Sequence[torch.device]):
        self.slots = list(slots)

    def bounds(self, n: int) -> List[Tuple[int, int]]:
        """Each slot's ``[start, stop)`` of ``n`` rows, in slot order."""
        return shard_bounds(n, len(self.slots))


def frame_sharding(mesh: Mesh, axis_name: str = "frame") -> FrameSharding:
    """Sharding for an (N, H, W) frame batch: split the frame axis over the
    slots of ``axis_name``."""
    return FrameSharding(mesh.slots(axis_name))
