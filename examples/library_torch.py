"""Library-API demo of the PyTorch + CUDA port: whole-collection tracking
with one batched device scan per shape group.

The port's version of ``examples/library.py``. Where
``examples/demo_torch.py`` drives the CLI, this shows the pure Python API a
pipeline embeds, importing only ``hsip_tpu_torch``:

* synthesize a small mixed-geometry library (two camera shapes),
* track EVERY recording in one on-device scan per shape group
  (``track_collection_device`` — profiles never leave the device),
* print per-video results and the velocity history of one run.

    python examples/library_torch.py [workdir] [--device NAME] [--mesh]

The default device is the CUDA card, and the run fails without one;
``--device cpu`` names the CPU, where the kernels' plain PyTorch versions
run. ``--mesh`` shards each shape group's videos over all local cards
(with ``--device cpu``, over one CPU slot).
"""

import argparse
import sys
from pathlib import Path

try:
    from hsip_tpu_torch import open_collection
except ModuleNotFoundError:  # running from a checkout without pip install
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from hsip_tpu_torch import open_collection

from hsip_tpu_torch.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording
from hsip_tpu_torch.track import FileCalibration, FlameDetectorConfig, VideoSourceConfig


def build_library(root: Path) -> None:
    geometries = [(64, 768), (64, 768), (48, 384)]  # Nova, Nova, Mini-style
    for i, (h, w) in enumerate(geometries):
        flame = FlameSpec(x0=25, v0_px=6 + 3 * i, accel_px=0.2,
                          ignition_frame=2, seed=60 + i)
        frames, _ = synthesize_flame_video(60, height=h, width=w, flame=flame)
        write_recording(
            root / "videos", f"lib-run-{i + 1}-001", frames,
            spec=CihxSpec(width=w, height=h, total_frames=60,
                          record_rate=100_000, bit_depth=12),
        )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("workdir", nargs="?", default="./hsip-torch-library-demo")
    parser.add_argument("--device", default=None, metavar="NAME",
                        help="'cuda' (default), 'cuda:N' or 'cpu'")
    parser.add_argument("--mesh", action="store_true",
                        help="shard the video axis over the local cards")
    args = parser.parse_args(argv)

    from hsip_tpu_torch.track import track_collection_device
    from hsip_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    root = Path(args.workdir)
    build_library(root)

    src = VideoSourceConfig(name="Library", save_frame_images=False,
                            save_stacked_sequences=False)
    src.video_path = str(root / "videos")
    src.file_calibrations = [
        FileCalibration(calibration=0.000833333, position_offset=1.0159,
                        files=["run-1-", "run-2-"]),
        FileCalibration(calibration=0.000869565, position_offset=0.050237,
                        files=["run-3-"]),
    ]

    mesh = None
    if args.mesh:
        from hsip_tpu_torch.parallel import make_mesh

        # Local cards: in a multi-process run each process tracks its own
        # videos, so the mesh spans only its own cards (the rule the CLI's
        # --mesh follows).
        mesh = make_mesh("video", devices=None if device.type == "cuda" else [device])
        print(f"Sharding the video axis over {mesh.size} devices")

    with open_collection(src.video_path) as coll:
        print(coll.summary())
        outputs = track_collection_device(
            coll, FlameDetectorConfig(), source_config=src, device=device,
            mesh=mesh,
        )

        # Report inside the with-block: the videos are still open here, so
        # adding frame access (e.g. video[0] thumbnails) stays valid.
        for video, out in zip(coll, outputs):
            last = out.rows[-1] if out.rows else None
            print(
                f"{video.filepath.name}: {len(out.rows)} rows, "
                f"break={out.break_reason}, ddt={out.tracker.ddt_frame}, "
                f"last={last[:4] if last else None}"
            )

    # Velocity history (exact float64 columns) of the first recording.
    print("\nfirst recording velocity history (frame, v1, v2, vc):")
    for entry in outputs[0].tracker.get_velocity_history()[:5]:
        print("  ", entry)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
