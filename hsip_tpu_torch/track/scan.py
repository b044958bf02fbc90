"""Map-then-scan on a torch device: batched profiles, then the tracker.

Counterpart of :mod:`hsip_tpu.track.scan`. The map phase
(:func:`compute_profiles_batched`) stages each chunk of frames to the
device — only the packed centerline band when the native codec can gather
it and count the empty-frame pixels on the host — decodes there and runs
the band chain (the CUDA band kernel on a GPU). The scan then runs either
on the host in float64 (:func:`.host_scan.run_tracking_scan`, the copy of
the JAX package's host scan) or on the device (:func:`run_tracking_scan_device`, the CUDA
tracking-scan kernel on a GPU); in both cases the tables come from the
float64 host code, so they are byte-identical across backends. Over a mesh
(:func:`track_video` with ``mesh=``) the map phase shards the frames over
the mesh's slots with a one-band halo (:func:`_compute_profiles_sharded`).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.preprocess import (
    band_folds,
    band_margin,
    batch_centerline_profiles,
    reflect_indices,
)
from ..kernels.unpack import packed_band_profiles, packed_centerline_profiles
from ..utils.backend import resolve_device
from ..utils.profiling import StageTimes
from .batch import ScanHistory, build_device_scan_output
from .config import FlameDetectorConfig
from .cuda_scan import cuda_tracking_scan
from .device_scan import tracking_scan_plain
from .fused import release_staging, take_staging
from .host_scan import (
    MIN_SIGNAL_FRACTION,
    NOISE_THRESHOLD_FLOOR,
    FrameProfiles,
    TrackingOutput,
    _compute_profiles_host_exact,
    run_tracking_scan,
)
from .tracker import FlameTracker

__all__ = [
    "MapProfiles",
    "compute_profiles_batched",
    "profiles_to_torch",
    "run_tracking_scan_device",
    "scan_params",
    "track_video",
]


@dataclasses.dataclass
class MapProfiles(FrameProfiles):
    """Map-phase output plus the staging route it took: 'band+counts'
    (native fused band gather and counts), 'band' (band gather and a
    separate host count pass), 'packed' (full packed frames), 'decoded'
    (host-decoded frames) or 'host_exact' (float64 host ops)."""

    staging_route: str = "decoded"


def _stage(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through a pinned buffer of the staging
    pool (shared with the library path, :mod:`.fused`) and an asynchronous
    copy on a CUDA device, a plain ``from_numpy`` on the CPU. The buffer
    goes back to the pool with the copy's event, so it is filled again only
    after this copy has read it."""
    if device.type == "cuda":
        pinned = take_staging(
            host.shape, torch.from_numpy(np.empty(0, dtype=host.dtype)).dtype
        )
        pinned.numpy()[...] = host
        staged = pinned.to(device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(device))
        release_staging(pinned, copied)
        return staged
    if not host.flags.writeable:  # memmap views are read-only
        host = host.copy()
    return torch.from_numpy(np.ascontiguousarray(host))


def _runs(idxs: np.ndarray):
    """``idxs`` split into runs of consecutive frame indices."""
    return np.split(idxs, np.where(np.diff(idxs) != 1)[0] + 1)


def _multi_read(read, idxs: np.ndarray) -> np.ndarray:
    """``read(start, stop)`` of each run of ``idxs``, concatenated: one
    spanning read would decode every skipped frame in the gaps."""
    parts = [read(int(r[0]), int(r[-1]) + 1) for r in _runs(idxs)]
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def compute_profiles_batched(
    read_batch: Callable[[int, int], np.ndarray],
    n_frames: int,
    frame_shape: Tuple[int, int],
    background_scalar: float,
    config: FlameDetectorConfig,
    skip_frames: Sequence[int] = (),
    chunk_size: int = 256,
    read_packed: Optional[Callable[[int, int], np.ndarray]] = None,
    read_band: Optional[Callable] = None,
    count_fn: Optional[Callable] = None,
    read_band_counts: Optional[Callable] = None,
    band_bit_depth: int = 12,
    keep_device: bool = False,
    need_intensity: bool = True,
    need_raw: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
    stage_times=None,
    device=None,
) -> MapProfiles:
    """Map phase: per-frame centerline profiles on ``device``.

    Arguments as in :func:`hsip_tpu.track.scan.compute_profiles_batched`
    (staging callables, chunking, ``keep_device``, ``need_*``,
    ``progress``, ``stage_times``); ``device`` is the torch device of the
    map phase (``None`` means ``cuda``). With ``keep_device`` the (M, W)
    line sets stay on ``device`` as tensors; otherwise they come back as
    numpy arrays. Each chunk carries the previous processed frame at its
    head, so every differencing prior is in the same batch. The one
    geometry the band chain cannot reproduce (an even kernel over a
    folding band) takes the float64 host ops.
    """
    dev = resolve_device(device)
    skip = set(int(s) for s in skip_frames)
    processed = np.array([i for i in range(n_frames) if i not in skip], dtype=np.int64)
    m = processed.size
    h, w = frame_shape
    noise_threshold = max(NOISE_THRESHOLD_FLOOR, background_scalar * 0.5)
    use_band = read_band is not None and count_fn is not None
    k = config.morphology_kernel_size
    sigma = config.gaussian_sigma
    margin = band_margin(k, sigma)
    band_rows = reflect_indices(h // 2, margin, h)

    if k % 2 == 0 and band_folds(h // 2, margin, h):
        exact = _compute_profiles_host_exact(
            read_batch, n_frames, frame_shape, background_scalar, config,
            skip_frames, progress=progress,
        )
        exact = MapProfiles(**vars(exact), staging_route="host_exact")
        return profiles_to_torch(exact, dev) if keep_device else exact

    bg32 = float(np.float32(background_scalar))
    thr32 = float(np.float32(config.frame_diff_threshold))
    noise32 = float(np.float32(noise_threshold))

    # Chunk plan over the PROCESSED frames: each chunk after the first
    # starts with the previous processed frame (its prior), so row j's
    # differencing prior is row j-1. Skipped frames never enter a batch.
    chunks = []  # (pos, stop, needed, row0, row1)
    pos = 0
    while pos < m:
        stop = min(m, pos + (chunk_size if pos == 0 else chunk_size - 1))
        if pos > 0:
            needed = np.concatenate([processed[pos - 1:pos], processed[pos:stop]])
            offset = 1
        else:
            needed = processed[pos:stop].copy()
            offset = 0
        n_rows = needed.size
        chunks.append((pos, stop, needed, offset, n_rows))
        pos = stop

    def _multi_read_fused(needed):
        """Fused band+counts staging (skip-gap aware); None when the fused
        native pass is unavailable (the caller degrades to two passes)."""
        bands, cnts = [], []
        for r in _runs(needed):
            res = read_band_counts(int(r[0]), int(r[-1]) + 1, band_rows,
                                   background_scalar, noise_threshold)
            if res is None:
                return None
            bands.append(res[0])
            cnts.append(res[1])
        if len(bands) == 1:
            return bands[0], cnts[0]
        return np.concatenate(bands), np.concatenate(cnts)

    if stage_times is None:
        stage_times = StageTimes()  # unobserved; keeps the code one-path
    route = "band+counts" if use_band and read_band_counts is not None else (
        "band" if use_band else ("packed" if read_packed is not None else "decoded")
    )
    pending = []  # (pos, stop, row0, row1, sob, grad, intens, rawc, counts)
    count_pool = ThreadPoolExecutor(max_workers=1) if use_band else None
    try:
        for pos, stop, needed, row0, row1 in chunks:
            # Row j's prior is row j-1 of the chunk; row 0 has none.
            prior = torch.arange(-1, row1 - 1, dtype=torch.int32, device=dev)
            if use_band:
                # Only the band rows ship; the host counts the above-noise
                # pixels, fused with the band gather when the codec can.
                counts = None
                if read_band_counts is not None:
                    with stage_times.stage("read_gather"):
                        fused = _multi_read_fused(needed)
                    if fused is None:
                        read_band_counts = None  # stale .so: stop probing
                        route = "band"
                    else:
                        host, counts = fused
                if counts is None:
                    # Two-pass: the native count pass (releases the GIL)
                    # runs beside the band gather and the transfer.
                    counts = count_pool.submit(
                        stage_times.wrap("counts_host", _multi_read),
                        lambda a, b: count_fn(a, b, background_scalar,
                                              noise_threshold),
                        needed,
                    )
                    with stage_times.stage("read_gather"):
                        host = np.ascontiguousarray(_multi_read(
                            lambda a, b: read_band(a, b, band_rows), needed
                        ))
                with stage_times.stage("h2d"):
                    staged = _stage(host, dev)
                with stage_times.stage("device_dispatch"):
                    sob, grad, intens, rawc = packed_band_profiles(
                        staged, bg32, prior, thr32,
                        morphology_kernel_size=k, gaussian_sigma=sigma,
                        bit_depth=band_bit_depth,
                    )
            else:
                with stage_times.stage("read_gather"):
                    host = _multi_read(
                        read_packed if read_packed is not None else read_batch,
                        needed,
                    )
                with stage_times.stage("h2d"):
                    staged = _stage(host, dev)
                with stage_times.stage("device_dispatch"):
                    if read_packed is not None:
                        sob, grad, intens, rawc, counts = packed_centerline_profiles(
                            staged, h, w, bg32, prior, thr32, noise32,
                            morphology_kernel_size=k, gaussian_sigma=sigma,
                            bit_depth=band_bit_depth,
                        )
                    else:
                        sob, grad, intens, rawc, counts = batch_centerline_profiles(
                            staged, bg32, prior, thr32, noise32,
                            morphology_kernel_size=k, gaussian_sigma=sigma,
                        )
            del staged, host
            pending.append((pos, stop, row0, row1, sob, grad, intens, rawc, counts))
            if progress is not None:
                progress(stop, m)
    finally:
        if count_pool is not None:
            count_pool.shutdown(wait=False)

    def _counts_of(c):
        c = c.result() if hasattr(c, "result") else c
        return c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)

    signal_counts = np.zeros(m, dtype=np.int64)
    with stage_times.stage("drain"):
        for pos, stop, a, b, *_lines, counts in pending:
            signal_counts[pos:stop] = _counts_of(counts)[a:b]
        if keep_device:
            # The (M, W) line sets stay on the device for the device scan.
            lines = [
                torch.cat([p[4 + i][p[2]:p[3]] for p in pending])
                if pending else torch.zeros((0, w), dtype=torch.float32, device=dev)
                for i in range(4)
            ]
            sobel_lines, gradient_lines, intensity_lines, raw_center_lines = lines
        else:
            sobel_lines = np.zeros((m, w), dtype=np.float32)
            gradient_lines = np.zeros((m, w), dtype=np.float32)
            intensity_lines = np.zeros((m, w), dtype=np.float32)
            raw_center_lines = np.zeros((m, w), dtype=np.float32)
            for pos, stop, a, b, sob, grad, intens, rawc, _c in pending:
                # Fetch only the line sets the detection method reads.
                sobel_lines[pos:stop] = sob[a:b].cpu().numpy()
                gradient_lines[pos:stop] = grad[a:b].cpu().numpy()
                if need_intensity:
                    intensity_lines[pos:stop] = intens[a:b].cpu().numpy()
                if need_raw:
                    raw_center_lines[pos:stop] = rawc[a:b].cpu().numpy()

    has_prior = np.ones(m, dtype=bool)
    if m:
        has_prior[0] = False
    return MapProfiles(
        frame_indices=processed,
        sobel_lines=sobel_lines,
        gradient_lines=gradient_lines,
        intensity_lines=intensity_lines,
        raw_center_lines=raw_center_lines,
        signal_counts=signal_counts,
        has_prior=has_prior,
        width=w,
        total_pixels=h * w,
        staging_route=route,
    )


def _compute_profiles_sharded(
    video,
    background_scalar: float,
    config: FlameDetectorConfig,
    skip_frames: Sequence[int],
    mesh,
    frames_per_shard: int = 512,
    keep_device: bool = False,
    need_intensity: bool = True,
    need_raw: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
    stage_times=None,
) -> MapProfiles:
    """Map phase over a mesh: the frames split along its 'frame' axis, one
    contiguous shard a slot, with the one-band halo for the differencing
    priors (:mod:`hsip_tpu_torch.parallel.sharding`).

    Counterpart of :func:`hsip_tpu.track.scan._compute_profiles_sharded`.
    Streams the recording in chunks of ``frames_per_shard * slots`` with a
    one-frame overlap (each chunk's first frame is the previous chunk's
    last, carrying the differencing prior; its output row is dropped), so
    the host and device footprint stays bounded on long recordings.
    ``skip_frames`` are compacted out before sharding (each processed frame
    diffs against the previous PROCESSED frame), and an even kernel over a
    folding band takes the float64 host ops, as in
    :func:`compute_profiles_batched`.

    Where the codec gathers the packed band rows and counts on the host,
    it gathers each chunk in one pass and each slot receives only its
    contiguous (ragged) share of the band bytes — the same staging as the
    unsharded map phase, so the profiles are bit-equal to its; a slot past
    a short last chunk's frames sits that chunk out. Otherwise each slot
    receives its decoded frames, the chunk padded to the slot count with
    copies of its last frame. With ``keep_device`` the line sets come back
    as tensors on the first slot's device.
    """
    from ..parallel.mesh import frame_sharding
    from ..parallel.sharding import make_sharded_profile_fn, shard_packed_band_profiles

    slots = frame_sharding(mesh, "frame")
    first = slots.slots[0]
    n_shards = len(slots.slots)
    h, w = video.frame_shape
    k, sigma = config.morphology_kernel_size, config.gaussian_sigma
    margin = band_margin(k, sigma)
    if k % 2 == 0 and band_folds(h // 2, margin, h):
        exact = _compute_profiles_host_exact(
            video.read_batch, len(video), video.frame_shape, background_scalar,
            config, skip_frames, progress=progress,
        )
        exact = MapProfiles(**vars(exact), staging_route="host_exact")
        return profiles_to_torch(exact, first) if keep_device else exact

    if stage_times is None:
        stage_times = StageTimes()
    skip = set(int(s) for s in skip_frames)
    processed = np.array([i for i in range(len(video)) if i not in skip], dtype=np.int64)
    m = processed.size
    noise_threshold = max(NOISE_THRESHOLD_FLOOR, background_scalar * 0.5)
    bg32 = float(np.float32(background_scalar))
    thr32 = float(np.float32(config.frame_diff_threshold))
    chunk = max(n_shards, frames_per_shard * n_shards)
    band_rows = reflect_indices(h // 2, margin, h)
    _read_packed, read_band, count_fn, depth = video.staging_paths()
    use_band = read_band is not None and count_fn is not None
    route = "band+counts" if use_band else "decoded"
    profile_fn = None if use_band else make_sharded_profile_fn(mesh, h, w, k, sigma)

    def _band_and_counts(idxs):
        nonlocal route
        if route == "band+counts":
            parts = [video.band_bytes_and_counts(int(r[0]), int(r[-1]) + 1, band_rows,
                                                 background_scalar, noise_threshold)
                     for r in _runs(idxs)]
            if len(parts) == 1 and parts[0] is not None:
                return parts[0]
            if all(p is not None for p in parts):
                return (np.concatenate([p[0] for p in parts]),
                        np.concatenate([p[1] for p in parts]))
            route = "band"  # stale native library: two passes from here on
        counts = _multi_read(
            lambda a, b: count_fn(a, b, background_scalar, noise_threshold), idxs)
        return _multi_read(lambda a, b: read_band(a, b, band_rows), idxs), counts

    pending = []  # (start, stop, off, sob, grad, intens, raw, counts): slot lists
    start = 0
    while start < m:
        stop = min(m, start + chunk)
        lo_pos = max(0, start - 1)  # one-frame overlap carries the prior
        idxs = processed[lo_pos:stop]
        if use_band:
            with stage_times.stage("read_gather"):
                host, cnt = _band_and_counts(idxs)
            shards = [(dev, a, b) for dev, (a, b)
                      in zip(slots.slots, slots.bounds(idxs.size)) if b > a]
            with stage_times.stage("h2d"):
                staged = [_stage(host[a:b], dev) for dev, a, b in shards]
            counts = [cnt[a:b] for _, a, b in shards]
            with stage_times.stage("device_dispatch"):
                shards = shard_packed_band_profiles(
                    staged, bg32, thr32, morphology_kernel_size=k,
                    gaussian_sigma=sigma, bit_depth=depth,
                )
            lines = [list(x) for x in zip(*shards)]
        else:
            idxs = np.concatenate([idxs, np.repeat(idxs[-1:], (-idxs.size) % n_shards)])
            with stage_times.stage("read_gather"):
                frames = _multi_read(video.read_batch, idxs)
            with stage_times.stage("device_dispatch"):
                *lines, counts = profile_fn(frames, background_scalar,
                                            config.frame_diff_threshold,
                                            noise_threshold)
        pending.append((start, stop, start - lo_pos, *lines, counts))
        start = stop
        if progress is not None:
            progress(stop, m)

    def _rows(shards, off, n, dev=None):
        """A chunk's rows from its slot shards: the overlap row (and any
        padding) dropped; on ``dev``, or as numpy."""
        if dev is None:
            return np.concatenate([
                s.cpu().numpy() if isinstance(s, torch.Tensor) else np.asarray(s)
                for s in shards])[off:off + n]
        return torch.cat([s.to(dev) for s in shards])[off:off + n]

    signal_counts = np.zeros(m, dtype=np.int64)
    wanted = (True, True, need_intensity, need_raw)
    with stage_times.stage("drain"):
        for start, stop, off, *_lines, counts in pending:
            signal_counts[start:stop] = _rows(counts, off, stop - start)
        if keep_device:
            lines = [
                torch.cat([_rows(p[3 + i], p[2], p[1] - p[0], first) for p in pending])
                if pending else torch.zeros((0, w), dtype=torch.float32, device=first)
                for i in range(4)
            ]
        else:
            lines = [np.zeros((m, w), dtype=np.float32) for _ in range(4)]
            for start, stop, off, *chunk_lines, _counts in pending:
                for i, want in enumerate(wanted):
                    if want:
                        lines[i][start:stop] = _rows(chunk_lines[i], off, stop - start)

    has_prior = np.ones(m, dtype=bool)
    if m:
        has_prior[0] = False
    return MapProfiles(
        frame_indices=processed,
        sobel_lines=lines[0],
        gradient_lines=lines[1],
        intensity_lines=lines[2],
        raw_center_lines=lines[3],
        signal_counts=signal_counts,
        has_prior=has_prior,
        width=w,
        total_pixels=h * w,
        staging_route=route,
    )


def profiles_to_torch(profiles: FrameProfiles, device) -> FrameProfiles:
    """A map-phase output (numpy lines from either package) with its (M, W)
    line sets as contiguous float32 tensors on ``device``."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32)).to(dev).contiguous()

    return dataclasses.replace(
        profiles,
        sobel_lines=t(profiles.sobel_lines),
        gradient_lines=t(profiles.gradient_lines),
        intensity_lines=t(profiles.intensity_lines),
        raw_center_lines=t(profiles.raw_center_lines),
    )


def scan_params(config: FlameDetectorConfig, frame_rate: float,
                calibration_m_per_px: float, method: str) -> dict:
    """The scan's scalar arguments, cast exactly as the JAX package casts
    them for its device scans (float32 thresholds, frame rate and
    calibration; the int32 displacement cap of the host tracker; the
    detector's own fraction). Keyword-compatible with both
    ``hsip_tpu.track.device_scan.device_tracking_scan`` and this package's
    scans."""
    fraction = (
        config.threshold_fraction if method == "threshold"
        else config.half_maximum_fraction
    )
    max_disp = FlameTracker(config, frame_rate, calibration_m_per_px).max_displacement_px
    return dict(
        min_gradient_strength=np.float32(config.min_gradient_strength),
        sobel_threshold_fraction=np.float32(config.sobel_threshold_fraction),
        ddt_velocity_jump=np.float32(config.ddt_velocity_jump_m_s),
        calibration=np.float32(calibration_m_per_px),
        frame_rate=np.float32(frame_rate),
        max_displacement_px=np.int32(max_disp),
        edge_margin_px=np.int32(config.edge_margin_px),
        search_window_px=np.int32(config.search_window_px),
        exit_margin_px=np.int32(config.exit_margin_px),
        method=method,
        method_fraction=np.float32(fraction),
    )


def run_tracking_scan_device(
    profiles: FrameProfiles,
    config: FlameDetectorConfig,
    frame_rate: float,
    calibration_m_per_px: float,
    position_offset_m: float = 0.0,
    time_fn=None,
    detection_method: str = "combined",
    use_frame_diff: bool = True,
    stage_times=None,
) -> TrackingOutput:
    """Scan phase on the profiles' device (tensors from
    ``compute_profiles_batched(keep_device=True)`` or
    :func:`profiles_to_torch`).

    A CUDA device launches the tracking-scan kernel; only a CPU device runs
    the plain PyTorch scan. One (M,) transfer of integer positions comes
    back; the exit / velocity-drop / DDT decisions and the velocity columns
    are recomputed from them in float64 (row-identical to the host scan).
    """
    if stage_times is None:
        stage_times = StageTimes()
    if time_fn is None:
        time_fn = lambda i: i / frame_rate if frame_rate > 0 else 0.0  # noqa: E731

    m = profiles.frame_indices.size
    if m == 0:
        return TrackingOutput(rows=[], tracker=ScanHistory([], {}, None))
    empty = profiles.signal_counts / profiles.total_pixels < MIN_SIGNAL_FRACTION
    intensity, has_prior = profiles.select_intensity(detection_method, use_frame_diff)
    if detection_method == "combined":
        sob, grad, inten = profiles.sobel_lines[None], profiles.gradient_lines[None], None
        dev = sob.device
    else:
        sob = grad = None
        inten = intensity[None]
        dev = inten.device
    params = scan_params(config, frame_rate, calibration_m_per_px, detection_method)
    fi = torch.as_tensor(profiles.frame_indices.astype(np.int32))[None].to(dev)
    em = torch.as_tensor(np.asarray(empty, dtype=bool))[None].to(dev)
    hp = torch.as_tensor(np.asarray(has_prior, dtype=bool))[None].to(dev)
    scan = tracking_scan_plain if dev.type == "cpu" else cuda_tracking_scan
    with stage_times.stage("scan_dispatch"):
        res = scan(fi, sob, grad, em, hp, width=profiles.width,
                   intensity_lines=inten, **params)
    with stage_times.stage("d2h"):
        finals = res.final_position[0].cpu().numpy()
    with stage_times.stage("tables"):
        return build_device_scan_output(
            np.asarray(profiles.frame_indices),
            empty,
            finals,
            width=profiles.width,
            exit_margin_px=config.exit_margin_px,
            ddt_velocity_jump=config.ddt_velocity_jump_m_s,
            frame_rate=frame_rate,
            calibration=calibration_m_per_px,
            position_offset=position_offset_m,
            time_fn=time_fn,
            total_frames=0,  # caller (track_video) fills the length
        )


def track_video(
    video,
    config: FlameDetectorConfig,
    calibration_m_per_px: float,
    position_offset_m: float = 0.0,
    skip_frames: Sequence[int] = (),
    use_absolute_time: bool = True,
    chunk_size: Optional[int] = None,
    background_scalar: Optional[float] = None,
    on_result=None,
    detection_method: str = "combined",
    use_frame_diff: bool = True,
    scan: str = "host",
    mesh=None,
    progress: Optional[Callable[[int, int], None]] = None,
    stage_times=None,
    device=None,
) -> TrackingOutput:
    """End-to-end tracking of one :class:`~hsip_tpu.video.PhotonVideo`.

    The map phase runs on ``device`` (``None`` means ``cuda``); ``scan``
    picks where the tracker runs: 'host' (float64 numpy, supports viz
    hooks) or 'device' (profiles never leave the device). The background
    is frame 0's max unless given.

    With ``mesh`` (a :class:`~hsip_tpu_torch.parallel.mesh.Mesh` with a
    'frame' axis) the map phase runs on the mesh's slots instead of
    ``device``: the frames split over them with a one-band halo for the
    differencing priors (:func:`_compute_profiles_sharded`), serial-identical
    at any slot count; ``chunk_size`` then bounds the frames of a streamed
    chunk (``chunk_size // slots`` a slot, default 512 a slot). It composes
    with either scan: the device scan runs on the first slot's device.
    """
    if scan not in ("host", "device"):
        raise ValueError(f"Unknown scan backend {scan!r} ('host' or 'device')")
    if scan == "device" and on_result is not None:
        raise ValueError("viz hooks require scan='host'")
    if mesh is None:
        dev = resolve_device(device)
    if background_scalar is None:
        background_scalar = float(np.max(video[0]))

    need_intensity = detection_method != "combined" and use_frame_diff
    need_raw = detection_method != "combined" and not use_frame_diff
    t0 = time.perf_counter()
    if mesh is not None:
        sharded_kwargs = {}
        if chunk_size is not None:
            sharded_kwargs["frames_per_shard"] = max(1, chunk_size // mesh.shape["frame"])
        profiles = _compute_profiles_sharded(
            video, background_scalar, config, skip_frames, mesh,
            keep_device=scan == "device", need_intensity=need_intensity,
            need_raw=need_raw, progress=progress, stage_times=stage_times,
            **sharded_kwargs,
        )
    else:
        read_packed, read_band, count_fn, storage_depth = video.staging_paths()
        if chunk_size is None:
            chunk_size = 4096 if read_band is not None else 256
        profiles = compute_profiles_batched(
            read_batch=video.read_batch,
            n_frames=len(video),
            frame_shape=video.frame_shape,
            background_scalar=background_scalar,
            config=config,
            skip_frames=skip_frames,
            chunk_size=chunk_size,
            read_packed=read_packed,
            read_band=read_band,
            count_fn=count_fn,
            read_band_counts=(
                video.band_bytes_and_counts if read_band is not None else None
            ),
            band_bit_depth=storage_depth,
            keep_device=scan == "device",
            need_intensity=need_intensity,
            need_raw=need_raw,
            progress=progress,
            stage_times=stage_times,
            device=dev,
        )
    t_map = time.perf_counter() - t0
    time_fn = video.get_absolute_time if use_absolute_time else video.get_time
    t0 = time.perf_counter()
    if scan == "device":
        out = run_tracking_scan_device(
            profiles,
            config,
            frame_rate=video.frame_rate,
            calibration_m_per_px=calibration_m_per_px,
            position_offset_m=position_offset_m,
            time_fn=time_fn,
            detection_method=detection_method,
            use_frame_diff=use_frame_diff,
            stage_times=stage_times,
        )
    else:
        out = run_tracking_scan(
            profiles,
            config,
            frame_rate=video.frame_rate,
            calibration_m_per_px=calibration_m_per_px,
            position_offset_m=position_offset_m,
            time_fn=time_fn,
            on_result=on_result,
            detection_method=detection_method,
            use_frame_diff=use_frame_diff,
        )
    out.phase_timings = {
        "map_s": round(t_map, 4),
        "scan_s": round(time.perf_counter() - t0, 4),
        "staging_route": profiles.staging_route,
    }
    if stage_times is not None:
        out.phase_timings["stages"] = stage_times.as_dict()
    out.total_frames = len(video)
    return out
