"""Parallel runtime: device meshes, the sharded map phase, process-level
distribution with the MPI-era API.

Counterpart of ``hsip_tpu/parallel/__init__.py`` (the reference's
``src/photron/parallel.py``, MPIVideoProcessor): a mesh of device slots in
one process (:mod:`.mesh`, :mod:`.sharding`) and whole recordings spread
over processes (:mod:`.processor`, ``torch.distributed`` on gloo).
``VideoProcessor`` stands where the JAX package has ``TPUVideoProcessor``.
Every name loads on first use, so ``import hsip_tpu_torch.parallel``
imports no torch.
"""

_LAZY = {
    "VideoProcessor": "processor",
    "initialize_distributed": "processor",
    "make_mesh": "mesh",
    "video_frame_mesh": "mesh",
    "frame_sharding": "mesh",
    "make_sharded_profile_fn": "sharding",
    "sharded_centerline_profiles": "sharding",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "VideoProcessor",
    "initialize_distributed",
    "make_mesh",
    "video_frame_mesh",
    "frame_sharding",
    "make_sharded_profile_fn",
    "sharded_centerline_profiles",
]
