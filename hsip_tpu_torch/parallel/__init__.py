"""Parallel runtime: process-level distribution with the MPI-era API.

Counterpart of ``hsip_tpu/parallel/__init__.py``, which also exports the
device-mesh layer (``make_mesh``, ``video_frame_mesh``, ``frame_sharding``,
``make_sharded_profile_fn``, ``sharded_centerline_profiles``). That layer
shards one process's work over several GPUs; it is not ported yet and comes
together with the command line's ``--mesh``. What is here spreads whole
recordings over processes.
"""

from .processor import VideoProcessor, initialize_distributed

__all__ = ["VideoProcessor", "initialize_distributed"]
