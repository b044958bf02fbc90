"""Collection-scale tracking: many videos, one scan per shape group.

Counterpart of :mod:`hsip_tpu.track.batch`. :func:`track_collection_device`
groups a collection's videos by frame shape and tracks each group on a
torch ``device``: through the fused group program of :mod:`.fused` when its
preconditions hold, else through the general chunked path here (a per-video
map phase, profiles padded to a common length and stacked, one scan over
the video axis). On a CUDA device the scan is the CUDA tracking-scan kernel
and the band chain the CUDA band kernel; on a CPU device their plain
PyTorch versions run. There is no other choice of scan and no degrade from
one to the other. Over a mesh (``mesh=``) each group's videos split into
contiguous shards over the slots of its 'video' axis, and each slot maps,
collates and scans its own videos on its own device.

:class:`ScanHistory` and :func:`build_device_scan_output` are plain numpy
copies of the JAX package's: the scan emits integer positions; the exit /
velocity-drop truncation, the DDT latch and the row labels are recomputed
here in float64, exactly as the host scan decides them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import FlameDetectorConfig, VideoSourceConfig
from .host_scan import MIN_SIGNAL_FRACTION, FrameProfiles, TrackingOutput
from .tracker import FlameTracker
from .velocity import (
    ddt_frame_from_velocities,
    iter_velocity_entries,
    velocities_from_positions,
)

__all__ = ["track_collection_device", "ScanHistory", "build_device_scan_output",
           "LAST_GROUP_PATHS", "MAX_GROUP_BYTES"]

# Introspection: which library path each uniform-shape group took on the
# most recent track_collection_device call — "fused" (one device program)
# or "chunked" (general map-then-scan). A silent fall to the chunked path
# would pass parity while losing what the fused path is for, so callers
# that care assert on this.
LAST_GROUP_PATHS: List[str] = []

# Default bound on a sub-batch's padded line sets (see
# :func:`_split_by_footprint`), chosen for the NVIDIA H100 (80 GB): 4 GiB
# of line sets. At the default band of 19 rows the fused program of such a
# sub-batch holds about 8 times that (its packed payload and float32 band
# beside the lines), which stays under the fused path's budget of half the
# card.
MAX_GROUP_BYTES = 4 << 30


class ScanHistory:
    """Tracker-shaped view over device-scan results (velocity history, DDT).

    Quacks like :class:`~hsip_tpu.track.tracker.FlameTracker` for the
    surfaces consumers use (``get_velocity_history``, ``ddt_frame``,
    ``ddt_detected``, ``position_history``, ``last_position``).
    """

    def __init__(self, entries, velocity_map, ddt_frame):
        self._entries = entries  # [(frame, pos|None), ...]
        self._vel = velocity_map  # {frame: (v1, v2, vc)}
        self._ddt = ddt_frame

    @property
    def position_history(self):
        return list(self._entries)

    @property
    def last_position(self):
        for _, p in reversed(self._entries):
            if p is not None:
                return p
        return None

    @property
    def ddt_frame(self):
        return self._ddt

    @property
    def ddt_detected(self):
        return self._ddt is not None

    def get_velocity_history(self):
        return [(f, v1, v2, vc) for f, (v1, v2, vc) in sorted(self._vel.items())]

    def get_pre_ddt_velocities(self):
        if self._ddt is None:
            return self.get_velocity_history()
        return [e for e in self.get_velocity_history() if e[0] < self._ddt]

    def get_post_ddt_velocities(self):
        if self._ddt is None:
            return []
        return [e for e in self.get_velocity_history() if e[0] >= self._ddt]


def build_device_scan_output(
    frame_indices,
    empty,
    finals,
    width: int,
    exit_margin_px: int,
    ddt_velocity_jump: float,
    frame_rate: float,
    calibration: float,
    position_offset: float,
    time_fn,
    total_frames: int,
) -> TrackingOutput:
    """Reconstruct a TrackingOutput from device-scan positions.

    The kernels' own f32 stop/DDT latches are advisory: an f32-computed v1
    can land on the other side of the reference's strict ``prev_v1 > 100``
    gate than the float64 value, so the kernels track past their own stop
    and the decisions are derived here from the integer positions, which
    are exact on every backend.
    """
    # The per-step history exactly as the kernels append it (every
    # non-empty step), with the float64 v1 sequence produced lazily by the
    # one shared velocity-append rule, so the replay stops paying for
    # velocities the moment it breaks.
    steps = []  # (step_idx, frame, pos|None) per non-empty step
    for j in range(len(frame_indices)):
        if not empty[j]:
            pos = int(finals[j]) if finals[j] >= 0 else None
            steps.append((j, int(frame_indices[j]), pos))

    rows = []
    stop_step = -1
    stop_reason = None
    clear_vc_entry = -1
    n_hist = 0  # steps whose history entry the tracker keeps (stop incl.)
    vel_all = []  # the generator's (single, growing) velocity-entry list
    vel_gen = iter_velocity_entries(
        ((frame, pos) for _, frame, pos in steps), frame_rate, calibration
    )
    for (j, frame, pos), vel_all in zip(steps, vel_gen):
        n_hist += 1
        k = len(vel_all)  # velocity entries appended at or before this step
        detected = pos is not None
        # Exit check BEFORE recording.
        if detected and pos >= width - exit_margin_px:
            stop_step, stop_reason = j, "exit"
        # Sudden >50% velocity drop, from >100 m/s, judged on the last two
        # appended velocity entries, fresh or stale.
        elif (
            k >= 2
            and vel_all[k - 2][1] > 100
            and (vel_all[k - 2][1] - vel_all[k - 1][1]) / vel_all[k - 2][1]
            > 0.5
        ):
            stop_step, stop_reason = j, "velocity_drop"
        if stop_step >= 0:
            # clear_last_central_difference targets entry[-2] (ordinal).
            if k >= 2:
                clear_vc_entry = k - 2
            break
        if detected:
            rows.append((frame, time_fn(frame), pos,
                         pos * calibration + position_offset))

    # DDT latches before the break checks, so the stop step's own velocity
    # entry participates; a row is post-DDT iff its frame is at or past the
    # first above-threshold v1 jump.
    ddt_frame = ddt_frame_from_velocities(vel_all, ddt_velocity_jump)
    rows = [
        (frame, t, pos, pos_m,
         ddt_frame is not None and frame >= ddt_frame)
        for frame, t, pos, pos_m in rows
    ]
    entries = [(frame, pos) for _, frame, pos in steps[:n_hist]]
    # Empty-frame count stops where the reference loop breaks.
    last_j = steps[n_hist - 1][0] if n_hist else len(frame_indices)
    n_empty = sum(bool(empty[j]) for j in range(last_j)) if stop_step >= 0 \
        else sum(bool(e) for e in empty)
    vel = velocities_from_positions(
        entries, frame_rate, calibration, clear_vc_entry=clear_vc_entry
    )
    history = ScanHistory(entries, vel, ddt_frame)
    return TrackingOutput(
        rows=rows,
        tracker=history,
        empty_frame_count=n_empty,
        break_frame=int(frame_indices[stop_step]) if stop_step >= 0 else None,
        break_reason=stop_reason,
        total_frames=total_frames,
    )


def track_collection_device(
    collection,
    config: Optional[FlameDetectorConfig] = None,
    source_config: Optional[VideoSourceConfig] = None,
    use_absolute_time: bool = True,
    chunk_size: Optional[int] = None,
    mesh=None,
    max_group_bytes: int = MAX_GROUP_BYTES,
    stage_times=None,
    device=None,
) -> List[TrackingOutput]:
    """Track every video of a collection with batched device scans on
    ``device`` (``None`` means ``cuda``).

    Videos sharing (H, W) batch into ONE scan over the video axis; a
    mixed-shape collection (e.g. two camera models in one library) runs one
    scan per shape group, results returned in collection order. Per-video
    calibration/offset come from ``source_config.get_calibration_for_file``
    (defaults 1.0 / 0.0). Returns one :class:`TrackingOutput` per video,
    identical to running the serial host scan on each.

    Each shape group's device-resident profile footprint (videos are padded
    to the group's longest frame count) is bounded by ``max_group_bytes``:
    oversized groups split into sub-batches, ordered by frame count so
    padding stays minimal — a 500-video library cannot overflow the card,
    and one 100k-frame recording doesn't pad fifty 2k-frame ones to 100k
    steps. Per-video results are independent, so sub-batching never changes
    output tables.

    With ``mesh`` (a :class:`~hsip_tpu_torch.parallel.mesh.Mesh` with a
    'video' axis) the groups run on the mesh's slots instead of ``device``:
    each group's videos split into contiguous shards, one a slot (the last
    slots get none when V is below the slot count), each mapped, collated
    and scanned on its slot's device; on the fused path each slot runs its
    own group programs (:mod:`.fused`). Per-video results are independent,
    so the tables equal the unsharded run's.

    ``stage_times`` (a :class:`~hsip_tpu_torch.utils.StageTimes`)
    accumulates host wall-clock per pipeline stage across ALL
    videos/sub-batches — staging stages from the map phase plus ``collate``
    (pad/stack), ``scan_dispatch``, ``d2h`` (the blocking device fetch) and
    ``tables`` (float64 host reconstruction). Map-pool threads overlap, so
    stage sums can exceed end-to-end wall-clock (see StageTimes).
    """
    from ..utils.backend import resolve_device

    dev = resolve_device(device) if mesh is None else None
    config = config or FlameDetectorConfig()
    LAST_GROUP_PATHS.clear()
    videos = list(collection)
    if not videos:
        return []
    groups: dict = {}
    for idx, video in enumerate(videos):
        groups.setdefault(video.frame_shape, []).append(idx)
    outputs: List[Optional[TrackingOutput]] = [None] * len(videos)
    for (_h, w), idxs in groups.items():
        for sub in _split_by_footprint(idxs, videos, w, max_group_bytes):
            group_outputs = _track_uniform_videos(
                [videos[i] for i in sub], w, config, source_config,
                use_absolute_time, chunk_size,
                stage_times=stage_times, device=dev, mesh=mesh,
            )
            for i, out in zip(sub, group_outputs):
                outputs[i] = out
    return outputs  # type: ignore[return-value]


# The scan holds up to 4 float32 (V, n_max, W) line sets per sub-batch
# (sobel, gradient, intensity, raw).
_PROFILE_ARRAYS = 4


def _split_by_footprint(idxs, videos, w: int, max_group_bytes: int):
    """Split a shape group into sub-batches whose padded profile footprint
    (V * n_max * W * 4 B * 4 arrays) stays under ``max_group_bytes``.

    Ordered by frame count, so each sub-batch's ``n_max`` is its last
    member's length and short recordings never pad to a long one's count.
    A single video over the budget still runs (sub-batch of one).
    """
    by_len = sorted(idxs, key=lambda i: len(videos[i]))
    batches, current = [], []
    for i in by_len:
        n_max = len(videos[i])  # ascending order: the max of current + [i]
        if current and (
            (len(current) + 1) * n_max * w * 4 * _PROFILE_ARRAYS
            > max_group_bytes
        ):
            batches.append(current)
            current = []
        current.append(i)
    if current:
        batches.append(current)
    return batches


def _track_uniform_videos(
    videos,
    w: int,
    config: FlameDetectorConfig,
    source_config: Optional[VideoSourceConfig],
    use_absolute_time: bool,
    chunk_size: Optional[int],
    stage_times=None,
    device=None,
    mesh=None,
) -> List[TrackingOutput]:
    """One device scan a slot over videos sharing a frame shape (the scan
    consumes width-``w`` profiles; height only shapes the map phase). The
    slots are ``device`` without a mesh, else ``mesh``'s 'video' slots, and
    the videos split into contiguous shards over them."""
    from ..parallel.mesh import slot_shards
    from ..utils.profiling import StageTimes
    from .cuda_scan import cuda_tracking_scan
    from .device_scan import tracking_scan_plain
    from .fused import _FusedResult, track_uniform_videos_fused
    from .scan import compute_profiles_batched, scan_params

    if stage_times is None:
        stage_times = StageTimes()  # unobserved; keeps the code one-path
    slots = [device] if mesh is None else mesh.slots("video")
    method = source_config.detection_method if source_config else "combined"
    use_frame_diff = source_config.use_frame_diff if source_config else True

    # --- fused fast path: the whole group as ONE device program ---
    # (band-staged groups without skip lists; falls through to the general
    # chunked path when preconditions fail — track/fused.py.)
    fused = track_uniform_videos_fused(
        videos, w, config, source_config, use_absolute_time,
        stage_times=stage_times, device=device, mesh=mesh,
    )
    if fused is not None:
        LAST_GROUP_PATHS.append("fused")
        return fused
    LAST_GROUP_PATHS.append("chunked")

    shards = slot_shards(slots, len(videos))
    video_device = {i: slot for slot, idxs in shards for i in idxs}

    # --- map phase per video (chunked, packed on-device decode), on its
    # slot's device ---
    # A small thread pool overlaps one video's HOST work (the native fused
    # band gather and count, GIL-releasing) with another's transfer and
    # device work. Order is preserved via executor.map.
    def _map_one(i) -> FrameProfiles:
        video = videos[i]
        bg = float(np.max(video[0]))
        read_packed, read_band, _count_fn, storage_depth = video.staging_paths()
        cs = chunk_size or (4096 if read_band is not None else 256)
        return compute_profiles_batched(
            read_batch=video.read_batch,
            n_frames=len(video),
            frame_shape=video.frame_shape,
            background_scalar=bg,
            config=config,
            skip_frames=(
                source_config.skip_frames if source_config is not None else ()
            ),
            chunk_size=cs,
            read_packed=read_packed,
            read_band_counts=(
                video.band_bytes_and_counts if read_band is not None else None
            ),
            band_bit_depth=storage_depth,
            keep_device=True,
            stage_times=stage_times,
            device=video_device[i],
        )

    if len(videos) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(4, len(videos))) as pool:
            profiles: List[FrameProfiles] = list(pool.map(_map_one, range(len(videos))))
    else:
        profiles = [_map_one(0)]

    # --- pad to a common step count; padding rows are 'empty' (no-ops) ---
    with stage_times.stage("collate"):
        n_max = max(p.frame_indices.size for p in profiles)
        V = len(videos)
        fi = np.zeros((V, n_max), dtype=np.int32)
        empty = np.ones((V, n_max), dtype=bool)
        has_prior = np.ones((V, n_max), dtype=bool)
        cals = np.zeros(V, dtype=np.float32)
        fpss = np.zeros(V, dtype=np.float32)
        max_disps = np.zeros(V, dtype=np.int32)
        calibs: List[Tuple[float, float]] = []
        for i, (video, p) in enumerate(zip(videos, profiles)):
            m = p.frame_indices.size
            fi[i, :m] = p.frame_indices
            fi[i, m:] = (p.frame_indices[-1] if m else 0) + np.arange(1, n_max - m + 1)
            empty[i, :m] = p.signal_counts / p.total_pixels < MIN_SIGNAL_FRACTION
            has_prior[i, :m] = p.select_intensity(method, use_frame_diff)[1]
            if source_config is not None:
                cal, off = source_config.get_calibration_for_file(video.filepath.name)
            else:
                cal, off = 1.0, 0.0
            calibs.append((cal, off))
            cals[i] = cal
            fpss[i] = video.frame_rate
            max_disps[i] = FlameTracker(config, video.frame_rate, cal).max_displacement_px

    # --- one device scan a slot over its videos: the CUDA kernel on a CUDA
    # device, the plain PyTorch scan on the CPU. Profile lines stay
    # DEVICE-resident: each video's (m, W) stack lands in its rows of its
    # slot's zeroed (V_s, n_s, W) tensor. Only the line sets the detection
    # method reads are stacked; the scan takes None for the others. ---
    params = scan_params(config, 1.0, 1.0, method)
    scanned = []  # (video indices, steps, final positions on the device)
    for slot, idxs in shards:
        n_s = max(profiles[i].frame_indices.size for i in idxs)
        if n_s == 0:  # every frame of the slot's videos skipped
            continue
        with stage_times.stage("collate"):
            def _stacked():
                return torch.zeros((len(idxs), n_s, w), dtype=torch.float32,
                                   device=slot)

            sob = grad = intens = None
            if method == "combined":
                sob, grad = _stacked(), _stacked()
            else:
                intens = _stacked()
            for j, i in enumerate(idxs):
                p = profiles[i]
                m = p.frame_indices.size
                if method == "combined":
                    sob[j, :m] = p.sobel_lines
                    grad[j, :m] = p.gradient_lines
                else:
                    intens[j, :m] = p.select_intensity(method, use_frame_diff)[0]
        scan = tracking_scan_plain if slot.type == "cpu" else cuda_tracking_scan
        with stage_times.stage("scan_dispatch"):
            res = scan(
                torch.from_numpy(fi[idxs, :n_s]).to(slot), sob, grad,
                torch.from_numpy(empty[idxs, :n_s]).to(slot),
                torch.from_numpy(has_prior[idxs, :n_s]).to(slot),
                width=w, intensity_lines=intens,
                **dict(params, calibration=cals[idxs], frame_rate=fpss[idxs],
                       max_displacement_px=max_disps[idxs]),
            )
        scanned.append((idxs, n_s, res.final_position))

    # The fetch, after every slot's scan is enqueued.
    finals = np.full((V, n_max), -1, dtype=np.int32)
    with stage_times.stage("d2h"):
        for idxs, n_s, positions in scanned:
            finals[idxs, :n_s] = positions.cpu().numpy()
    return _outputs_from_scan(
        _FusedResult(finals), videos, profiles, fi, empty, calibs,
        use_absolute_time, config, stage_times=stage_times,
    )


def _outputs_from_scan(res, videos, profiles, fi, empty, calibs,
                       use_absolute_time,
                       config: FlameDetectorConfig,
                       stage_times=None) -> List[TrackingOutput]:
    """Host reconstruction shared by the fused and chunked paths: rows,
    float64 velocities, and the authoritative float64 truncation/DDT
    decisions per video — the scans emit integer positions (their f32 stop
    latches are advisory; see build_device_scan_output).
    ``res.final_position`` is a (V, n) tensor on any device or a numpy
    array already on the host."""
    from ..utils.profiling import StageTimes

    if stage_times is None:
        stage_times = StageTimes()
    outputs: List[TrackingOutput] = []
    # The ONE blocking device fetch of the scan results: every device wait
    # the free-running map phase hid lands here.
    with stage_times.stage("d2h"):
        finals = res.final_position
        if isinstance(finals, torch.Tensor):
            finals = finals.cpu().numpy()

    with stage_times.stage("tables"):
        for i, (video, p) in enumerate(zip(videos, profiles)):
            m = p.frame_indices.size
            cal, off = calibs[i]
            time_fn = video.get_absolute_time if use_absolute_time else video.get_time
            outputs.append(
                build_device_scan_output(
                    fi[i, :m],
                    empty[i, :m],
                    finals[i, :m],
                    width=p.width,
                    exit_margin_px=config.exit_margin_px,
                    ddt_velocity_jump=config.ddt_velocity_jump_m_s,
                    frame_rate=video.frame_rate,
                    calibration=cal,
                    position_offset=off,
                    time_fn=time_fn,
                    total_frames=len(video),
                )
            )
    return outputs
