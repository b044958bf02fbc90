"""VideoProcessor: process-level distribution with the MPI-era API.

Counterpart of ``hsip_tpu/parallel/processor.py`` (``TPUVideoProcessor``,
itself a drop-in for the reference's ``MPIVideoProcessor``,
``src/photron/parallel.py:16-298``): same surface — rank/size/is_root/
is_parallel, ``distribute_indices`` (round_robin / contiguous),
``process_collection`` / ``process_videos``, broadcast / gather / allgather /
scatter / barrier / reduce_sum / allreduce_sum — built on
``torch.distributed``:

* ranks        → the processes of the default process group
* bcast/gather → ``broadcast_object_list`` / ``all_gather_object``
* Reduce/Allreduce(SUM) → a numpy sum over the rank-ordered all-gather (not
  a tree reduce: the rounding is the same at any process count)
* serial mode when there is a single process — every collective is the
  identity, so the whole pipeline runs unchanged in one process (the
  reference's ``comm=None`` contract).

The backend is **gloo on every machine**, a GPU machine too: every
collective here carries pickled host objects and numpy arrays (file
indices, stop flags, result rows), never a device tensor, so no NCCL group
is needed. Each rank computes on the device :meth:`VideoProcessor.
local_device` names; several ranks may share one card.

Call :func:`initialize_distributed` before constructing in multi-process
runs.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Callable, List, Optional, Tuple, TypeVar

import numpy as np
import torch
import torch.distributed as dist

from ..utils.backend import resolve_device

T = TypeVar("T")

__all__ = ["VideoProcessor", "initialize_distributed"]


def _group_is_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = 300.0,
) -> None:
    """Join the multi-process run (gloo); a no-op when a group is up already.

    With ``coordinator_address`` (``HOST:PORT`` of rank 0) the group is
    formed over ``tcp://HOST:PORT`` and needs ``num_processes`` and
    ``process_id``. Without it the launcher's environment is read
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` sets them).

    Raises when neither is there, and re-raises a failed initialisation —
    silently degrading to serial rank 0 would make every process handle all
    videos and overwrite shared outputs. ``timeout_s`` bounds the
    rendezvous and every later collective.
    """
    if _group_is_up():
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "a coordinator address needs num_processes and process_id"
            )
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=timeout,
        )
        return
    needed = ["MASTER_ADDR", "MASTER_PORT"]
    if process_id is None:
        needed.append("RANK")
    if num_processes is None:
        needed.append("WORLD_SIZE")
    missing = [k for k in needed if k not in os.environ]
    if missing:
        raise RuntimeError(
            "cannot form the process group: no coordinator address given "
            f"and {', '.join(missing)} not set in the environment"
        )
    dist.init_process_group(
        "gloo", init_method="env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, timeout=timeout,
    )


class VideoProcessor:
    """Distribute video/frame work across processes.

    Example:
        >>> processor = VideoProcessor()
        >>> indices = processor.distribute_indices(len(video))
        >>> results = processor.process_collection(collection, analyze_frame)
        >>> if processor.is_root:
        ...     save_results(results)
    """

    def __init__(self, use_distributed: Optional[bool] = None):
        """``use_distributed=None`` auto-detects an initialised process
        group of more than one process; False forces serial mode (testing)."""
        world = dist.get_world_size() if _group_is_up() else 1
        if use_distributed is None:
            use_distributed = world > 1
        self._distributed = bool(use_distributed) and world > 1
        self._rank = dist.get_rank() if self._distributed else 0
        self._size = world if self._distributed else 1

    # -- identity ------------------------------------------------------------

    @property
    def rank(self) -> int:
        """This process's index (0 in serial mode)."""
        return self._rank

    @property
    def size(self) -> int:
        """Total processes (1 in serial mode)."""
        return self._size

    @property
    def is_root(self) -> bool:
        return self._rank == 0

    @property
    def is_parallel(self) -> bool:
        return self._distributed and self._size > 1

    def local_device(self, kind=None) -> torch.device:
        """The device this rank computes on.

        ``kind`` is a device or its name; ``None`` means ``cuda``. ``cpu``
        and a CUDA device named with its index stay as they are; plain
        ``cuda`` becomes ``cuda:N`` with N the launcher's ``LOCAL_RANK``
        when set, else the rank, modulo ``torch.cuda.device_count()`` —
        so the ranks of a machine take its cards in turn, and four ranks
        on a one-card machine share ``cuda:0``. Raises ``RuntimeError``
        when a CUDA device is asked for and none is available.
        """
        dev = resolve_device(kind)
        if dev.type != "cuda" or dev.index is not None:
            return dev
        local_rank = int(os.environ.get("LOCAL_RANK", self._rank))
        return torch.device("cuda", local_rank % torch.cuda.device_count())

    # -- index distribution ----------------------------------------------------

    def distribute_indices(
        self, total_count: int, distribution: str = "round_robin"
    ) -> List[int]:
        """Indices assigned to this process.

        round_robin: interleaved (i % size == rank). contiguous: equal blocks
        with the remainder spread over the first ranks.
        """
        if distribution == "round_robin":
            return [i for i in range(total_count) if i % self._size == self._rank]
        if distribution == "contiguous":
            chunk, rem = divmod(total_count, self._size)
            if self._rank < rem:
                start = self._rank * (chunk + 1)
                end = start + chunk + 1
            else:
                start = rem * (chunk + 1) + (self._rank - rem) * chunk
                end = start + chunk
            return list(range(start, end))
        raise ValueError(f"Unknown distribution strategy: {distribution}")

    # -- high-level maps ------------------------------------------------------------

    def _gather_sorted(self, local, gather_results: bool):
        """``local`` (index, result) pairs, or all ranks' sorted on root."""
        if gather_results and self.is_parallel:
            gathered = self.gather(local)
            if self.is_root:
                flat = [item for sub in gathered for item in sub]
                flat.sort(key=lambda x: x[0])
                return flat
            return None
        return local

    def process_collection(
        self,
        collection,
        process_func: Callable[[np.ndarray, int], T],
        gather_results: bool = True,
        distribution: str = "round_robin",
    ) -> Optional[List[Tuple[int, T]]]:
        """Map ``process_func(frame, global_idx)`` over a collection's frames,
        distributed across processes; optionally gather sorted to root."""
        my_indices = self.distribute_indices(collection.total_frames, distribution)
        local = [
            (g, process_func(collection.get_global_frame(g), g)) for g in my_indices
        ]
        return self._gather_sorted(local, gather_results)

    def process_videos(
        self,
        collection,
        process_video_func: Callable[[Any, int], T],
        gather_results: bool = True,
    ) -> Optional[List[Tuple[int, T]]]:
        """Map over whole videos (one video per task)."""
        my_indices = self.distribute_indices(len(collection))
        local = [(v, process_video_func(collection[v], v)) for v in my_indices]
        return self._gather_sorted(local, gather_results)

    # -- collectives -------------------------------------------------------------------

    def broadcast(self, data: Any, root: int = 0) -> Any:
        """Broadcast a picklable object from ``root`` to all processes."""
        if not self.is_parallel:
            return data
        box = [data if self._rank == root else None]
        dist.broadcast_object_list(box, src=root)
        return box[0]

    def gather(self, data: Any, root: int = 0) -> Optional[List[Any]]:
        """Gather picklable objects to ``root`` (None elsewhere)."""
        gathered = self.allgather(data)
        if not self.is_parallel or self._rank == root:
            return gathered
        return None

    def allgather(self, data: Any) -> List[Any]:
        """Gather picklable objects to ALL processes, in rank order."""
        if not self.is_parallel:
            return [data]
        gathered = [None] * self._size
        dist.all_gather_object(gathered, data)
        return gathered

    def scatter(self, data: Optional[List[Any]], root: int = 0) -> Any:
        """Scatter a root-held list, one element per process."""
        if not self.is_parallel:
            return data[0] if data else None
        full = self.broadcast(data, root=root)
        return full[self._rank]

    def barrier(self) -> None:
        """Synchronize all processes."""
        if self.is_parallel:
            dist.barrier()

    def reduce_sum(self, data: np.ndarray, root: int = 0) -> Optional[np.ndarray]:
        """Element-wise sum across processes, result on ``root`` only."""
        result = self.allreduce_sum(data)
        if not self.is_parallel or self._rank == root:
            return result
        return None

    def allreduce_sum(self, data: np.ndarray) -> np.ndarray:
        """Element-wise sum across processes, result everywhere."""
        if not self.is_parallel:
            return data
        stacked = np.stack(self.allgather(np.asarray(data)))
        return stacked.sum(axis=0)

    def __repr__(self) -> str:
        mode = "parallel" if self.is_parallel else "serial"
        return f"<VideoProcessor rank={self._rank}/{self._size} mode={mode}>"
