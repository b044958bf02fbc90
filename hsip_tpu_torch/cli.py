"""Command-line entry point: configured video-source processing.

Counterpart of ``hsip_tpu/cli.py`` for the PyTorch + CUDA port: the same
TOML/JSON config files and the same flags, on a CUDA device instead of a
TPU. The run's device is ``--device`` (``cuda``, ``cuda:N`` or ``cpu``;
default the card), resolved once before any recording is opened: without a
card and without ``--device cpu`` the command exits 2, it never carries on
on the CPU by itself.

    hsip-torch --video-path ./Nova-Video-Files --output-dir ./out --name Nova
    hsip-torch --config run.toml
    hsip-torch --config run.toml --backend exact --no-images
    hsip-torch --config run.toml --library --device cpu

Config file schema (TOML):

    [[source]]
    name = "Nova"
    enabled = true
    video_path = "./Nova-Video-Files"
    output_dir = "./Processed-Photos/Nova-Output"
    calibration = 1.0
    position_offset = 0.0
    use_absolute_time = true
    skip_frames = []

    [[source.file_calibration]]
    calibration = 0.000833333
    position_offset = 1.0159
    files = ["run-1-"]

    [detector]
    frame_diff_threshold = 5.0
    gaussian_sigma = 1.5
    # ... any FlameDetectorConfig field

``--library --mesh [N]`` shards each shape group's videos over N local
cards in one process (all of them when N is omitted or 0; under
``--distributed`` the rank's own cards); with ``--device cpu`` it puts N
slots on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from .track.config import FileCalibration, FlameDetectorConfig, VideoSourceConfig

__all__ = ["main", "load_config", "build_parser", "entry"]


def _load_config_file(path: Path) -> Dict[str, Any]:
    if path.suffix.lower() == ".json":
        return json.loads(path.read_text())
    if path.suffix.lower() == ".toml":
        try:
            import tomllib
        except ImportError:  # Python 3.10 (requires-python >= 3.10)
            try:
                import tomli as tomllib
            except ImportError:
                raise RuntimeError(
                    "TOML configs need Python >= 3.11 (stdlib tomllib) or "
                    "the 'tomli' package; use a JSON config otherwise"
                ) from None

        return tomllib.loads(path.read_text())
    raise ValueError(f"Unsupported config format: {path.suffix} (use .toml or .json)")


_SOURCE_KEYS = ({
    f.name for f in dataclasses.fields(VideoSourceConfig) if not f.name.startswith("_")
} | {"video_path", "output_dir", "file_calibration", "file_calibrations"}) - {
    # Always set to the config file's directory (relative video_path/
    # output_dir resolve against it); a user-supplied value would be
    # silently ignored, so reject it via the unknown-key error instead.
    "base_path",
}


def _source_from_dict(d: Dict[str, Any], base_path: Optional[str]) -> VideoSourceConfig:
    unknown = set(d) - _SOURCE_KEYS
    if unknown:
        raise ValueError(f"Unknown source config keys: {sorted(unknown)}")
    style = d.get("figure_style", "full")
    if style not in ("full", "compact"):
        raise ValueError(
            f"Invalid figure_style {style!r} (expected 'full' or 'compact')"
        )
    method = d.get("detection_method", "combined")
    if method not in ("combined", "threshold", "gradient", "half_maximum"):
        # Fail at config-parse time, not after a full map phase per file.
        raise ValueError(
            f"Invalid detection_method {method!r} (expected 'combined', "
            f"'threshold', 'gradient' or 'half_maximum')"
        )
    fcs = [
        FileCalibration(
            calibration=fc["calibration"],
            position_offset=fc.get("position_offset", 0.0),
            files=list(fc.get("files", [])),
        )
        for fc in d.get("file_calibration", d.get("file_calibrations", []))
    ]
    cfg = VideoSourceConfig(
        name=d.get("name", "source"),
        enabled=d.get("enabled", True),
        calibration=d.get("calibration", 1.0),
        position_offset=d.get("position_offset", 0.0),
        trigger_frame=d.get("trigger_frame"),
        detection_method=d.get("detection_method", "combined"),
        use_frame_diff=d.get("use_frame_diff", True),
        use_absolute_time=d.get("use_absolute_time", True),
        skip_frames=list(d.get("skip_frames", [])),
        file_calibrations=fcs,
        save_frame_images=d.get("save_frame_images", True),
        save_stacked_sequences=d.get("save_stacked_sequences", True),
        figure_style=style,
        base_path=base_path,
    )
    if d.get("video_path"):
        cfg.video_path = d["video_path"]
    if d.get("output_dir"):
        cfg.output_dir = d["output_dir"]
    return cfg


def _detector_from_dict(d: Dict[str, Any]) -> FlameDetectorConfig:
    valid = {f.name for f in dataclasses.fields(FlameDetectorConfig)}
    unknown = set(d) - valid
    if unknown:
        raise ValueError(f"Unknown detector config keys: {sorted(unknown)}")
    return FlameDetectorConfig(**d)


def load_config(path) -> tuple:
    """Load (sources, detector_config) from a TOML/JSON config file."""
    path = Path(path)
    raw = _load_config_file(path)
    base = str(path.parent.resolve())
    sources = [_source_from_dict(s, base) for s in raw.get("source", [])]
    detector = _detector_from_dict(raw.get("detector", {}))
    return sources, detector


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hsip-torch",
        description=(
            "High-speed camera processing on PyTorch + CUDA: flame-front "
            "tracking and DDT detection over Photron CIHX/MRAW recordings."
        ),
    )
    from . import __version__

    parser.add_argument(
        "--version", action="version", version=f"hsip_tpu_torch {__version__}"
    )
    parser.add_argument("--config", type=Path, help="TOML/JSON config file")
    parser.add_argument(
        "--detection-method",
        choices=("combined", "threshold", "gradient", "half_maximum"),
        default=None,
        help="front-detection method (overrides config-file sources when "
        "given; default: combined, the reference tracker)",
    )
    parser.add_argument("--video-path", help="directory of .cihx recordings")
    parser.add_argument("--output-dir", help="output directory")
    parser.add_argument("--name", default="source", help="source name")
    parser.add_argument(
        "--calibration", type=float, default=None,
        help="default m/pixel (overrides config-file sources when given)",
    )
    parser.add_argument(
        "--position-offset", type=float, default=None,
        help="default offset in m (overrides config-file sources when given)",
    )
    parser.add_argument("--trigger-frame", type=int, default=None)
    parser.add_argument(
        "--relative-time",
        action="store_true",
        help="trigger-relative time instead of absolute (PFV4) time",
    )
    parser.add_argument(
        "--backend",
        choices=("gpu", "device", "exact"),
        default=None,
        help="gpu: device map + host scan; device: fully on-device "
             "tracking (per-frame figures render via a row-identical "
             "host-scan replay); exact: serial float64 host, needs no "
             "device. Default: auto — 'device' when per-frame figures are "
             "off, else 'gpu' (same rows, no replay cost). Incompatible "
             "with --library (which always runs the batched device path)",
    )
    parser.add_argument(
        "--library",
        action="store_true",
        help="library mode: batch ALL recordings of each source into one "
             "on-device scan per shape group (fastest for many files; "
             "identical tables)",
    )
    parser.add_argument(
        "--mesh",
        nargs="?",
        type=int,
        const=0,
        default=None,
        metavar="N",
        help="with --library: shard each shape group's video axis over N "
             "GPUs (omit N — or pass 0 — for all local GPUs; under "
             "--distributed, the process's own GPUs). With --device cpu: N "
             "slots on the CPU (one when N is omitted)",
    )
    parser.add_argument(
        "--info",
        action="store_true",
        help="print each recording's parsed metadata (frames, geometry, "
             "timing, matched calibration) and exit without processing",
    )
    parser.add_argument(
        "--no-images", action="store_true", help="skip per-frame diagnostic figures"
    )
    parser.add_argument(
        "--no-sequences", action="store_true", help="skip stacked-sequence plots"
    )
    parser.add_argument(
        "--figure-style", choices=("full", "compact"), default=None,
        help="per-frame figure style: full 12-panel or compact 4-panel",
    )
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument(
        "--resume",
        action="store_true",
        help="skip recordings already completed (checkpoint ledger in output dir)",
    )
    parser.add_argument(
        "--watch",
        nargs="?",
        type=float,
        const=10.0,
        default=None,
        metavar="SECONDS",
        help="serve mode: keep polling each source directory (default every "
             "10 s) and process recordings as they appear; implies --resume "
             "semantics between passes. Stop with Ctrl-C",
    )
    parser.add_argument(
        "--profile-dir",
        default=None,
        help="capture a torch.profiler trace (Chrome trace JSON) into this "
             "directory",
    )
    parser.add_argument(
        "--device",
        default=None,
        metavar="NAME",
        help="the device to compute on: 'cuda' (default), 'cuda:N' or "
             "'cpu'. The CPU runs only when named: without a CUDA device "
             "and without --device cpu the command exits 2",
    )
    parser.add_argument(
        "--distributed",
        action="store_true",
        help="multi-process run (videos distributed across processes; "
             "torch.distributed over gloo)",
    )
    parser.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="with --distributed: rank 0's address for manual launches "
             "(otherwise read from the launcher's environment: RANK, "
             "WORLD_SIZE, MASTER_ADDR, MASTER_PORT)",
    )
    parser.add_argument(
        "--num-processes", type=int, default=None,
        help="with --distributed: total process count for manual launches",
    )
    parser.add_argument(
        "--process-id", type=int, default=None,
        help="with --distributed: this process's rank for manual launches",
    )
    return parser


def _print_info(sources: List[VideoSourceConfig]) -> int:
    """``--info``: parsed metadata per recording, no processing.

    The reference prints this block only mid-run (per-file dumps at
    ``process_videos.py:1326-1354``); here it's available standalone. It
    touches no device.
    """
    from . import open_video

    found_any = False
    for cfg in sources:
        if not cfg.enabled or not cfg.video_path:
            continue
        files = sorted(Path(cfg.video_path).rglob("*.cihx"))
        if files:
            print(f"\n{cfg.name}: {len(files)} recording(s) under "
                  f"{cfg.video_path}")
        for f in files:
            found_any = True
            cal, off = cfg.get_calibration_for_file(f.name)
            try:
                # Only the open/parse is guarded — a print failure (e.g.
                # SIGPIPE from `hsip-torch --info | head`) must not
                # masquerade as an unreadable recording.
                with open_video(str(f), trigger_frame=cfg.trigger_frame) as v:
                    d = v.describe()
            except Exception as exc:
                print(f"  {f.name}: UNREADABLE ({exc})")
                continue
            print(f"  {f.name}: {d['frames']} frames "
                  f"{d['height']}x{d['width']} {d['bit_depth']}-bit @ "
                  f"{d['frame_rate']:g} fps, "
                  f"duration {d['duration_s']:.6f} s, "
                  f"trigger {d['trigger_frame']}, "
                  f"calibration {cal} m/px, offset {off} m")
            if "cihx" in d:
                c = d["cihx"]
                print(f"    start_frame={c['start_frame']} "
                      f"skip_frame={c['skip_frame']} "
                      f"recorded={c['recording_datetime']} "
                      f"irig={c['irig']}")
    if not found_any:
        print("No recordings found", file=sys.stderr)
        return 1
    return 0


def _mesh_devices(n: int, device, named: Optional[str], processor) -> list:
    """The slots ``--mesh N`` may take: on the CPU N (at least one); a
    card named with its index alone; else the local cards, under
    ``--distributed`` this rank's share of them — disjoint cards when the
    machine has one or more a rank (``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` when a launcher sets them, else the rank and the
    process count), else the card the rank computes on, shared."""
    import os

    import torch

    if device.type == "cpu":
        return [device] * max(1, n)
    if named is not None and torch.device(named).index is not None:
        return [device]
    count = torch.cuda.device_count()
    if processor is None:
        return [torch.device("cuda", i) for i in range(count)]
    rank = int(os.environ.get("LOCAL_RANK", processor.rank))
    ranks = int(os.environ.get("LOCAL_WORLD_SIZE", processor.size))
    per = count // ranks
    if per == 0:
        return [device]
    return [torch.device("cuda", i) for i in range(rank * per, (rank + 1) * per)]


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    detector_config = FlameDetectorConfig()
    sources: List[VideoSourceConfig] = []

    if args.config:
        sources, detector_config = load_config(args.config)
    if args.video_path:
        cfg = VideoSourceConfig(
            name=args.name,
            enabled=True,
            calibration=args.calibration if args.calibration is not None else 1.0,
            position_offset=args.position_offset or 0.0,
            trigger_frame=args.trigger_frame,
            use_absolute_time=not args.relative_time,
        )
        cfg.video_path = args.video_path
        cfg.output_dir = args.output_dir or "./hsip-output"
        sources.append(cfg)

    if not sources:
        print("No sources configured: pass --video-path or --config", file=sys.stderr)
        return 2

    for cfg in sources:
        # Explicit flags override config-file sources too.
        if args.no_images:
            cfg.save_frame_images = False
        if args.no_sequences:
            cfg.save_stacked_sequences = False
        if args.figure_style:
            cfg.figure_style = args.figure_style
        if args.calibration is not None:
            cfg.calibration = args.calibration
        if args.position_offset is not None:
            cfg.position_offset = args.position_offset
        if args.trigger_frame is not None:
            cfg.trigger_frame = args.trigger_frame
        if args.relative_time:
            cfg.use_absolute_time = False
        if args.detection_method:
            cfg.detection_method = args.detection_method

    if args.info:
        # Before the device is resolved: works on a machine without a card.
        return _print_info(sources)

    if not args.distributed and any(
        v is not None
        for v in (args.coordinator, args.num_processes, args.process_id)
    ):
        # Without this, two manually-launched ranks would silently run as
        # independent serial processes, each writing ALL output tables.
        print("--coordinator/--num-processes/--process-id require "
              "--distributed", file=sys.stderr)
        return 2

    if args.mesh is not None and not args.library:
        print("--mesh requires --library (it shards the batched video axis)",
              file=sys.stderr)
        return 2
    if args.mesh is not None and args.mesh < 0:
        print(f"--mesh {args.mesh}: device count must be positive "
              "(omit N or pass 0 for all local devices)", file=sys.stderr)
        return 2
    if args.library and args.backend is not None:
        print(f"--backend {args.backend} is incompatible with --library "
              "(library mode always runs the batched on-device path)",
              file=sys.stderr)
        return 2

    # The process group comes first, so that the rank is known when the
    # device is chosen (several ranks of one machine take its cards in turn).
    processor = None
    if args.distributed:
        from .parallel import VideoProcessor, initialize_distributed

        try:
            initialize_distributed(
                coordinator_address=args.coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id,
            )
        except (RuntimeError, ValueError) as exc:
            print(f"--distributed: {exc}", file=sys.stderr)
            return 1
        processor = VideoProcessor()
        if processor.is_root:
            print(f"Running distributed: {processor.size} processes")

    # The device is resolved once, here, and handed to both runners. The
    # exact backend is host float64 and needs none.
    device = None
    if args.backend != "exact":
        from .utils.backend import resolve_device

        try:
            device = (processor.local_device(args.device)
                      if processor is not None
                      else resolve_device(args.device))
        except (RuntimeError, ValueError) as exc:
            print(f"--device {args.device or 'cuda'}: {exc}", file=sys.stderr)
            return 2

    mesh = None
    if args.mesh is not None:
        from .parallel.mesh import make_mesh

        # LOCAL cards: under --distributed each process tracks its own
        # recordings, so its mesh spans only its own cards.
        slots = _mesh_devices(args.mesh, device, args.device, processor)
        if args.mesh > len(slots):
            # Never run with fewer slots than asked, nor unsharded.
            print(f"--mesh {args.mesh}: only {len(slots)} local device(s) "
                  "available (omit N or pass 0 for all local devices)",
                  file=sys.stderr)
            return 2
        mesh = make_mesh("video", devices=slots, n_devices=args.mesh or None)
        if not args.quiet and (processor is None or processor.is_root):
            print(f"Sharding video axis over {mesh.size} devices"
                  + (" per process" if processor is not None else ""))

    from . import pipeline
    from .utils.profiling import profile_trace

    def run_pass(resume: bool, verbose: bool, failure_cache=None) -> int:
        n = 0
        for cfg in sources:
            if not cfg.enabled:
                continue
            if args.library:
                outs = pipeline.process_video_source_library(
                    cfg,
                    detector_config,
                    processor=processor,
                    verbose=verbose,
                    resume=resume,
                    failure_cache=failure_cache,
                    device=device,
                    mesh=mesh,
                )
            else:
                outs = pipeline.process_video_source(
                    cfg,
                    detector_config,
                    # Auto backend: figure-less runs take the fully
                    # on-device scan (identical tables, no per-frame viz
                    # hook needed); figure runs need the host scan's hook.
                    backend=args.backend or (
                        "gpu" if cfg.save_frame_images else "device"
                    ),
                    processor=processor,
                    verbose=verbose,
                    resume=resume,
                    failure_cache=failure_cache,
                    device=device,
                )
            n += len(outs)
        return n

    with profile_trace(args.profile_dir, device=device):
        if args.watch is not None:
            # Serve mode: the checkpoint ledger is the work queue — each
            # pass processes only recordings not yet marked complete, so
            # files landing in the directory are picked up on the next poll
            # (the first pass honors --resume; later passes always resume).
            # A device or kernel fault raised by a pass is not caught here:
            # it ends the run, it would fail every later pass the same way.
            import time as _time

            missing = [cfg.name for cfg in sources
                       if cfg.enabled and not cfg.output_dir]
            if missing:
                print(f"--watch requires an output dir on every source (the "
                      f"checkpoint ledger is the work queue); missing on: "
                      f"{', '.join(missing)}", file=sys.stderr)
                return 2
            interval = max(0.1, args.watch)
            if not args.quiet and (processor is None or processor.is_root):
                print(f"Watching for new recordings every {interval:g} s "
                      f"(Ctrl-C to stop)")
            # Shutdown sentinel: Ctrl-C (or an operator touching the file)
            # requests a stop that EVERY process honors at its next poll —
            # without it, interrupting one rank of a --distributed watch
            # left the others polling alone. A rank interrupted mid-pass
            # can still leave peers in the end-of-pass barrier; interrupt
            # between passes (or use the sentinel) for a clean stop.
            stop_sentinel = next(
                (Path(cfg.output_dir) / ".hsip-watch-stop"
                 for cfg in sources if cfg.enabled and cfg.output_dir),
                None,
            )
            if stop_sentinel is not None:
                if processor is None or processor.is_root:
                    stop_sentinel.unlink(missing_ok=True)
                if processor is not None:
                    # No rank may poll before the stale sentinel is gone.
                    processor.barrier()
            resume = args.resume
            verbose = not args.quiet
            # Corrupt recordings are retried only when their mtime/size
            # change; otherwise every poll would re-fail and re-warn them.
            failure_cache: Dict[str, Any] = {}
            stop_requested = False

            def _note_interrupt():
                nonlocal stop_requested
                stop_requested = True
                if stop_sentinel is not None:
                    # Also visible to future passes / co-located ranks.
                    stop_sentinel.parent.mkdir(parents=True, exist_ok=True)
                    stop_sentinel.touch()

            while True:
                stop = stop_requested or (
                    stop_sentinel is not None and stop_sentinel.exists()
                )
                if processor is not None:
                    # COLLECTIVE any-rank decision: every rank reaches this
                    # allgather each poll (an interrupted rank keeps
                    # looping instead of exiting), so no rank can leave
                    # while a peer enters the pass and hangs in the ledger
                    # barrier — and a Ctrl-C on one host propagates even
                    # without a shared output directory.
                    stop = any(processor.allgather(stop))
                if stop:
                    if not args.quiet and (
                        processor is None or processor.is_root
                    ):
                        print("\nWatch stopped (shutdown requested)")
                    return 0
                try:
                    done = run_pass(resume=resume, verbose=verbose,
                                    failure_cache=failure_cache)
                    # Later passes resume (completed work must not
                    # reprocess) and stay quiet — a verbose pass would
                    # re-announce every completed recording each poll.
                    resume = True
                    verbose = False
                    if not args.quiet and done and (
                        processor is None or processor.is_root
                    ):
                        print(f"\nWatch pass complete ({done} new); "
                              f"polling every {interval:g} s")
                    _time.sleep(interval)
                except KeyboardInterrupt:
                    # Between-pass (sleep) interrupts stop cleanly via the
                    # collective above. A mid-pass interrupt on one rank of
                    # a distributed run is best-effort: collectives may be
                    # left misaligned; interrupt between passes for a
                    # guaranteed-clean stop.
                    _note_interrupt()
                    if processor is None:
                        if not args.quiet:
                            print("\nWatch stopped")
                        return 0

        run_pass(resume=args.resume, verbose=not args.quiet)

    if processor is not None:
        processor.barrier()
    if processor is None or processor.is_root:
        print("\nProcessing complete!")
    return 0


def entry() -> int:
    """Console-script entry: ``main()`` with graceful SIGPIPE handling."""
    try:
        return main()
    except BrokenPipeError:
        # `hsip-torch --info | head` closes stdout early; exit quietly (the
        # devnull dup stops Python's shutdown from re-raising on stdout
        # flush).
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(entry())
