"""Mesh dry runs: the full sharded processing step on tiny shapes.

Counterpart of :mod:`hsip_tpu.parallel.dryrun`. Checks that the production
sharding runs at a given slot count: a 2-D (video × frame) mesh, the
halo-exchange map phase per video, the sums across both axes, candidate
extraction on each slot (the device half of the scan), the scan over the
video axis, and the library path over a video mesh. ``devices`` names the
slots (default: the local CUDA cards); a device may be named more than
once, so one card, or the CPU, can hold every slot.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "build_multichip_step",
    "run_multichip_dryrun",
    "run_pipeline_dryrun",
]


def build_multichip_step(mesh, height: int, width: int, axis_frame: str = "frame",
                         axis_video: str = "video"):
    """The full step over a ('video', 'frame') mesh.

    Returns ``step(frames, background, diff_threshold, noise_threshold) ->
    (pos_min_grad, pos_rightmost, total_signal, sobel, gradient)`` for
    (V, N, H, W) frames, V the mesh's video size and N divisible by its
    frame size. Per video, on its row of slots: background-subtract,
    band-extract, halo-exchange the differencing priors over the frame
    axis, centerline profiles (THE production shard body,
    :func:`.sharding.shard_band_profiles`), then on each slot the
    candidates (first-index argmin of the gradient, rightmost |Sobel| above
    0.1 × its max). ``total_signal`` is the sum of the above-noise counts
    over all videos and frames (both axes). The positions come back as
    (V, N) numpy arrays; ``sobel`` and ``gradient`` as one (N, W) tensor a
    video, on the first slot of its row.
    """
    import torch

    from .mesh import Mesh
    from .sharding import make_sharded_profile_fn

    video_ax = mesh.axis_names.index(axis_video)
    rows = [Mesh(np.take(mesh.devices, v, axis=video_ax), (axis_frame,))
            for v in range(mesh.shape[axis_video])]
    fns = [make_sharded_profile_fn(row, height, width, 3, 1.5, axis_name=axis_frame)
           for row in rows]

    def candidates(sob, grad):
        col = torch.arange(sob.shape[-1], device=sob.device)
        abs_sob = sob.abs()
        above = abs_sob > 0.1 * abs_sob.amax(dim=-1, keepdim=True)
        return (torch.argmin(grad, dim=-1),
                torch.where(above, col, -1).amax(dim=-1))

    def step(frames, background, diff_threshold, noise_threshold):
        pos_g, pos_s, sobs, grads = [], [], [], []
        total = 0
        for fn, row, video in zip(fns, rows, frames):
            sob, grad, _intens, _raw, counts = fn(video, background, diff_threshold,
                                                  noise_threshold)
            found = [candidates(s, g) for s, g in zip(sob, grad)]
            total += sum(int(c.sum()) for c in counts)
            pos_g.append(torch.cat([g.cpu() for g, _ in found]).numpy())
            pos_s.append(torch.cat([s.cpu() for _, s in found]).numpy())
            first = row.devices[0]
            sobs.append(torch.cat([s.to(first) for s in sob]))
            grads.append(torch.cat([g.to(first) for g in grad]))
        return np.stack(pos_g), np.stack(pos_s), float(total), sobs, grads

    return step


def run_multichip_dryrun(n_devices: int, height: int = 24, width: int = 128,
                         frames_per_shard: int = 2,
                         devices: Optional[Sequence] = None) -> Tuple:
    """Build an ``n_devices``-slot (video × frame) mesh over ``devices``,
    run the full step once on tiny shapes, then the tracking scan of each
    video on its row's first slot (the CUDA scan kernel on a CUDA slot).
    Returns ``(pos_min_grad, pos_rightmost, total_signal)``."""
    import torch

    from ..track.cuda_scan import cuda_tracking_scan
    from ..track.device_scan import tracking_scan_plain
    from .mesh import _as_devices, video_frame_mesh

    devices = _as_devices(devices)[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} devices, "
            f"found {len(devices)}"
        )
    # Two video groups when the slot count is even, else one.
    v = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    f = n_devices // v
    mesh = video_frame_mesh(v, devices)

    n_frames = f * frames_per_shard
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 4096, size=(v, n_frames, height, width), dtype=np.uint16)

    step = build_multichip_step(mesh, height, width)
    pos_g, pos_s, total, sobs, grads = step(frames, 100.0, 5.0, 50.0)
    assert pos_g.shape == (v, n_frames)
    assert pos_s.shape == (v, n_frames)

    # The second half of the production step: the tracking scan, one video
    # on each video row's first slot.
    has_prior = np.ones(n_frames, dtype=bool)
    has_prior[0] = False
    for sob, grad in zip(sobs, grads):
        dev = sob.device
        scan = tracking_scan_plain if dev.type == "cpu" else cuda_tracking_scan
        res = scan(
            torch.arange(n_frames, dtype=torch.int32, device=dev)[None],
            sob[None].contiguous(), grad[None].contiguous(),
            torch.zeros((1, n_frames), dtype=torch.bool, device=dev),
            torch.from_numpy(has_prior)[None].to(dev),
            width=width,
            min_gradient_strength=np.float32(10.0),
            sobel_threshold_fraction=np.float32(0.1),
            ddt_velocity_jump=np.float32(1250.0),
            calibration=np.float32(8.3e-4),
            frame_rate=np.float32(100_000.0),
            max_displacement_px=np.int32(3),
        )
        assert tuple(res.final_position.shape) == (1, n_frames)
    return pos_g, pos_s, total


def run_pipeline_dryrun(n_devices: int, devices: Optional[Sequence] = None):
    """End-to-end orchestration dry run on an ``n_devices``-slot video mesh.

    Where :func:`run_multichip_dryrun` checks the sharded step alone, this
    runs the production path the command line ships —
    ``pipeline.process_video_source_library``: recording discovery, the
    group program of every slot, and the tables — over three 14-frame
    24×128 recordings, with the mesh and without it (on the mesh's first
    slot), for 'combined' and 'gradient', and asserts the tables are
    byte-identical and the group took the fused path. Returns ``(number of
    recordings, group path)``.
    """
    import shutil
    import tempfile
    from pathlib import Path

    from ..io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording
    from ..pipeline import process_video_source_library
    from ..track.batch import LAST_GROUP_PATHS
    from ..track.config import FlameDetectorConfig, VideoSourceConfig
    from .mesh import make_mesh

    mesh = make_mesh("video", devices=devices, n_devices=n_devices)
    single_device = mesh.devices[0]

    tmp = Path(tempfile.mkdtemp(prefix="hsip-dryrun-"))
    try:
        spec = CihxSpec(width=128, height=24, total_frames=14,
                        record_rate=100_000, bit_depth=12)
        for i, flame in enumerate((
            FlameSpec(x0=15.0, v0_px=7.0, ignition_frame=1, seed=31),
            FlameSpec(x0=12.0, v0_px=5.0, ignition_frame=2, seed=32),
            FlameSpec(x0=18.0, v0_px=6.0, ignition_frame=1, seed=33),
        )):
            frames, _ = synthesize_flame_video(14, height=24, width=128,
                                               flame=flame)
            write_recording(tmp / "v", f"dry-run-{i + 1}-001", frames,
                            spec=spec)

        def run(out_name, use_mesh, method="combined"):
            cfg = VideoSourceConfig(
                name="Dryrun", calibration=8.3e-4,
                save_frame_images=False, save_stacked_sequences=False,
                detection_method=method,
            )
            cfg.video_path = str(tmp / "v")
            cfg.output_dir = str(tmp / out_name)
            outs = process_video_source_library(
                cfg, FlameDetectorConfig(), verbose=False,
                mesh=mesh if use_mesh else None, device=single_device,
            )
            if use_mesh and list(LAST_GROUP_PATHS) != ["fused"]:
                # A fall to the chunked path would pass the byte identity
                # below while losing what the fused path is for.
                raise AssertionError(
                    f"uniform-shape mesh group did not fuse: {LAST_GROUP_PATHS}")
            return outs

        def compare(mesh_dir, single_dir):
            mesh_tables = sorted((tmp / mesh_dir).glob("*.txt"))
            single_tables = sorted((tmp / single_dir).glob("*.txt"))
            assert mesh_tables, f"{mesh_dir}: mesh run wrote no tables"
            assert [t.name for t in mesh_tables] == [
                t.name for t in single_tables
            ], (mesh_tables, single_tables)
            for mt, st in zip(mesh_tables, single_tables):
                assert mt.read_bytes() == st.read_bytes(), (
                    f"sharded table differs: {mt.name}"
                )

        outs = run("out-mesh", use_mesh=True)
        run("out-single", use_mesh=False)
        compare("out-mesh", "out-single")
        # A named detector reads the intensity rows instead.
        run("out-mesh-g", use_mesh=True, method="gradient")
        run("out-single-g", use_mesh=False, method="gradient")
        compare("out-mesh-g", "out-single-g")
        return len(outs), "fused"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
