"""End-to-end demo of the PyTorch + CUDA port: synthesize a Nova+Mini-style
dataset, process it with ``hsip-torch``.

The port's version of ``examples/demo.py``: two camera sources with
different geometries, calibrations and detection methods, a TOML run
config, and the port's CLI. It imports only ``hsip_tpu_torch``.

    python examples/demo_torch.py [workdir] [extra CLI flags...]

Flags after the workdir are forwarded to the ``hsip-torch`` CLI verbatim —
e.g. ``--device cpu`` to run without a CUDA card (the default device is the
card, and the command exits 2 without one), ``--no-images --no-sequences``
for tables only, or ``--library`` for the batched path.
"""

import sys
from pathlib import Path

try:
    from hsip_tpu_torch.cli import main
except ModuleNotFoundError:  # running from a checkout without pip install
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from hsip_tpu_torch.cli import main
from hsip_tpu_torch.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording


def build_dataset(root: Path) -> None:
    # "Nova": wide fast runs with a DDT event.
    for run in (1, 2, 3):
        flame = FlameSpec(x0=30, v0_px=6 + run, accel_px=0.25, ignition_frame=3,
                          ddt_frame=30, v_jump_px=20, seed=100 + run)
        frames, _ = synthesize_flame_video(70, height=64, width=768, flame=flame)
        write_recording(
            root / "Nova-Video-Files", f"nova-run-{run}-001", frames,
            spec=CihxSpec(width=768, height=64, total_frames=70,
                          record_rate=100_000, start_frame=-12,
                          device_name="FASTCAM Nova S12"),
        )
    # "Mini": smaller, slower, strong static signal (threshold method).
    flame = FlameSpec(x0=25, v0_px=5, ignition_frame=2, seed=200,
                      background_level=60, flame_level=2500)
    frames, _ = synthesize_flame_video(50, height=48, width=384, flame=flame)
    write_recording(
        root / "Mini-Video-Files", "mini-run-1-001", frames,
        spec=CihxSpec(width=384, height=48, total_frames=50,
                      record_rate=80_000, device_name="FASTCAM Mini AX"),
    )


CONFIG = """
[[source]]
name = "Nova"
video_path = "{root}/Nova-Video-Files"
output_dir = "{root}/Processed/Nova-Output"
detection_method = "combined"

[[source.file_calibration]]
calibration = 0.000833333
position_offset = 1.0159
files = ["run-1-"]

# NOTE: range patterns ("A:B") compare the LAST integer in each filename
# (reference semantics) — with names like nova-run-2-001 that integer is
# the trailing 001, so a "run-2-:run-3-" range would never match. Use
# substring patterns for this naming scheme.
[[source.file_calibration]]
calibration = 0.000833333
position_offset = 1.197565
files = ["run-2-", "run-3-"]

[[source]]
name = "Mini"
video_path = "{root}/Mini-Video-Files"
output_dir = "{root}/Processed/Mini-Output"
detection_method = "threshold"
calibration = 0.000869565
position_offset = 0.050237
"""


if __name__ == "__main__":
    args = sys.argv[1:]
    if args and not args[0].startswith("-"):
        root, extra = Path(args[0]), args[1:]
    else:
        root, extra = Path("./hsip-torch-demo"), args
    root.mkdir(parents=True, exist_ok=True)
    build_dataset(root)
    cfg = root / "run.toml"
    cfg.write_text(CONFIG.format(root=root.resolve()))
    raise SystemExit(main(["--config", str(cfg), *extra]))
