"""Whole-library fused tracking: V videos, G pipelined device programs.

Counterpart of :mod:`hsip_tpu.track.fused`. The general library path
(:mod:`.batch`) runs a per-video map phase before the batched scan. This
module runs a group of same-shape recordings as ONE device program:

1. HOST: per-video band gather + packed noise counts (the native codec),
   straight into one pinned staging buffer; each video's bytes then go to
   the device with an asynchronous copy on a copy stream. The counts only
   decide which frames are empty, so each frame's count stops once it
   reaches the least count that makes the frame non-empty.
2. DEVICE, on the compute stream, every launch asynchronous: unpack the
   packed bits video by video, subtract each video's background, the band
   chain over the flat ``(V * n, B, W)`` batch with per-video priors (the
   CUDA band kernel on a GPU), then the tracking scan over V videos (the
   CUDA scan kernel on a GPU) — profiles never leave the device.
3. HOST: ONE fetch per group of the (V, n) integer positions; float64
   velocity/truncation reconstruction (``build_device_scan_output``)
   exactly as every other backend.

**Staging↔compute pipelining**: the library splits into G groups
(:func:`_fused_group_count`). Group g is gathered, copied and enqueued
before group g+1's gather begins, and no result is fetched until every
group is enqueued. PyTorch's launches do not block the host, so group g's
device program runs under group g+1's host gather, and the copy stream
lets group g+1's transfers overlap it.

**Over a mesh** (a :class:`~hsip_tpu_torch.parallel.mesh.Mesh` with a
'video' axis) the videos split into contiguous shards, one a slot; each
slot unpacks, runs the band chain and scans only its own videos, on its
own device, through its own copy stream. Where the JAX package runs one
``shard_map`` dispatch (``_fused_group_count(n, mesh) == 1``), each slot
here keeps its group pipeline, and the groups are gathered round robin
over the slots, so every slot's first program is enqueued after one gather
each; positions are fetched only after every slot's programs are enqueued.
The budget is per card: slots that share a card share its limit.

What the JAX module models of its link to a remote device (lazy or eager
puts, ``one_put`` against ``put_train``, the mesh put trains) has no
counterpart here: a pinned buffer, a copy stream and an event are the whole
transfer.

Bit-parity: the device chain is the same ``band_to_profiles`` and scan
every other path uses; per-video results are independent, so grouping
cannot change them — outputs are REQUIRED to be identical to the per-video
scan (tests/test_torch_library.py).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import FlameDetectorConfig, VideoSourceConfig
from .tracker import FlameTracker

__all__ = ["track_uniform_videos_fused", "take_staging", "release_staging"]

def _fused_limit_bytes(dev: torch.device) -> int:
    """The most :func:`_fused_budget_bytes` may come to on ``dev``: half of
    the device's memory. On the NVIDIA H100 (80 GB) the port targets that is
    half of what ``torch.cuda.mem_get_info`` reports as the card's total,
    about 40 GB; the other half is left to the allocator's cache, the
    chunked path's tensors and whatever else the process holds. A CPU
    device's memory is the host's."""
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[1] // 2
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 2


def _fused_group_count(n_videos: int) -> int:
    """Pipelined group count G for the fused library.

    G > 1 overlaps group g+1's host gather with group g's device program:
    each group is staged, copied and enqueued before the next group's
    gather begins, and no result is fetched until every group is enqueued.
    The serial exposure is ~(1/G)·(first gather + last program), so G=4
    hides ~3/4 of the device time behind host staging. ``min(4, V)`` groups
    by default, one for a single video; ``HSIP_FUSED_GROUPS`` overrides (an
    integer; ``auto`` = this rule).
    """
    if n_videos < 2:
        return 1
    env = os.environ.get("HSIP_FUSED_GROUPS", "auto")
    if env != "auto":
        try:
            return max(1, min(int(env), n_videos))
        except ValueError:
            return 1
    return min(4, n_videos)


# Reusable host staging buffers, shared by the fused groups and the map
# phase's chunks (:func:`hsip_tpu_torch.track.scan._stage`). Pinning a
# fresh multi-hundred-MB buffer per group or chunk pays the page locking
# every time. For a CUDA device the buffers are pinned; each is handed out
# to one user at a time, and comes back with the event recorded after the
# last copy that reads it: it is handed out again only once that event has
# completed. Keyed on (shape, dtype); pipelined groups alternate between at
# most two shapes (equal groups ±1 video), so a small bounded pool avoids
# re-allocating every group.
_STAGING_POOL: list = []  # idle buffers: (key, tensor, event or None)
_STAGING_POOL_MAX = 4
_STAGING_LOCK = threading.Lock()


def take_staging(shape, dtype=torch.uint8, pinned: bool = True) -> torch.Tensor:
    """An idle host staging tensor of ``shape`` from the pool (pinned when
    ``pinned``), or a fresh one. A buffer whose last copy has completed is
    preferred; with none, a new buffer is made while the pool has room,
    else the call waits for the oldest matching buffer's copy."""
    key = (tuple(int(s) for s in shape), dtype, bool(pinned))
    with _STAGING_LOCK:
        mine = [e for e in _STAGING_POOL if e[0] == key]
        pick = next((e for e in mine if e[2] is None or e[2].query()), None)
        if pick is None and mine and len(_STAGING_POOL) >= _STAGING_POOL_MAX:
            pick = mine[0]
        if pick is not None:
            _STAGING_POOL.remove(pick)
    if pick is None:
        return torch.empty(key[0], dtype=dtype, pin_memory=bool(pinned))
    if pick[2] is not None:
        pick[2].synchronize()
    return pick[1]


def release_staging(buf: torch.Tensor, event=None) -> None:
    """Hand a staging tensor back. ``event`` was recorded after the last
    copy that reads ``buf`` (None when no copy is in flight)."""
    key = (tuple(buf.shape), buf.dtype, buf.is_pinned())
    with _STAGING_LOCK:
        while len(_STAGING_POOL) >= _STAGING_POOL_MAX:
            _STAGING_POOL.pop(0)
        _STAGING_POOL.append((key, buf, event))


def count_fused_frames(stage_times, n_frames: int, bit_depth: int) -> None:
    """Count, in ``stage_times``, the frames one fused gather+count pass
    counted (``frames_counted``) and those of them a vector path of the
    native count covered (``frames_counted_vector``, 0 when none did)."""
    from .._native import native_decoder

    vector = native_decoder().vector_count(bit_depth)
    stage_times.count("frames_counted", n_frames)
    stage_times.count("frames_counted_vector", n_frames if vector else 0)


def empty_count_cap(total_pixels: int,
                    min_fraction: float) -> Optional[int]:
    """The least count ``c`` in ``[0, total_pixels]`` that makes a frame
    non-empty by the empty-frame rule ``c / float(total_pixels) <
    min_fraction``, from that expression itself; None when no count does.

    The rule is monotone in the count, so ``min(count, cap)`` decides every
    frame as its count does: the fused library's gather may stop a frame's
    count once it reaches the cap.
    """
    total = float(total_pixels)
    if total_pixels / total < min_fraction:
        return None
    lo, hi = 0, total_pixels
    while lo < hi:
        mid = (lo + hi) // 2
        if mid / total < min_fraction:
            lo = mid + 1
        else:
            hi = mid
    return lo


_COPY_STREAMS: dict = {}


def _copy_stream(dev: torch.device):
    """The stream host→device payload copies run on (one per device)."""
    key = (dev.type, dev.index if dev.index is not None
           else torch.cuda.current_device())
    stream = _COPY_STREAMS.get(key)
    if stream is None:
        _COPY_STREAMS[key] = stream = torch.cuda.Stream(dev)
    return stream


# Introspection for tests/tools: per-group pipeline timeline of the last
# fused call. One dict per group, host timestamps (perf_counter):
# gather_start_t / gather_end_t around the group's gathers, dispatch_t
# before its program is enqueued, inputs_ready_t when its copy event has
# completed, finals_ready_t when its results are fetched. The overlap
# (gather g+1 under program g) is read straight off these numbers.
_LAST_PIPELINE_TRACE: List[dict] = []


def _clip_threshold() -> float:
    """Coverage above which the empty-range clip is not taken.

    ``HSIP_CLIP_EMPTY`` overrides (a float in (0, 1]; ``off``/``0``
    disables). Default 0.7, as in the JAX package.
    """
    raw = os.environ.get("HSIP_CLIP_EMPTY", "0.7")
    if raw in ("off", "0"):
        return 0.0
    try:
        return float(raw)
    except ValueError:
        return 0.7


def _clip_ranges(empty: np.ndarray, lengths, n_max: int):
    """Per-video non-empty ranges for the clip, or None to skip.

    Returns ``(lo, L_each, L)`` — each video's range start
    ``max(0, first_nonempty - 1)`` (keeping the first signal frame's
    differencing prior in-range), per-video range lengths, and the padded
    common length (bucketed to a power of two, clamped to ``n_max``) — when
    total coverage is below the threshold; ``None`` when the batch is dense
    or the clip is disabled. Same rule, case by case, as
    ``hsip_tpu.track.fused._clip_ranges``.
    """
    thr = _clip_threshold()
    if thr <= 0.0:
        return None
    Vp = empty.shape[0]
    lo = np.zeros(Vp, np.int64)
    L_each = np.zeros(Vp, np.int64)
    for i, n in enumerate(lengths):
        nz = np.flatnonzero(~empty[i, :n])
        if nz.size == 0:
            continue  # all-empty video: nothing is copied, rows stay masked
        lo[i] = max(0, int(nz[0]) - 1)
        L_each[i] = int(nz[-1]) - lo[i] + 1
    total = int(L_each.sum())
    if total == 0 or total / float(Vp * n_max) > thr:
        return None
    L = max(1, int(L_each.max()))
    L = min(n_max, 1 << (L - 1).bit_length())
    if L / float(n_max) > thr:
        return None  # bucketing ate the saving
    return lo, L_each, L


def _gather_workers(n_videos: int) -> int:
    """Concurrent per-video gathers for the library staging pool.

    Each native gather is already internally parallel, so stacking several
    of them oversubscribes a small host. Default: serialize and let the
    codec's own threads do the overlapping. ``HSIP_GATHER_WORKERS``
    overrides for many-core hosts where parallel gathers win.
    """
    env = os.environ.get("HSIP_GATHER_WORKERS")
    if env:
        return max(1, min(int(env), n_videos))
    return 1


def _fused_budget_bytes(n_videos: int, n_max: int, w: int, band_rows: int,
                        depth: int, n_groups: int = 1) -> int:
    """Device bytes a fused call of ``n_videos`` in ``n_groups`` holds at
    its peak.

    An upper bound: every group's packed payload is counted, since the
    host enqueues ahead of the programs and a payload is freed only when
    the compute stream has passed its program. Where the device keeps up
    with the host's gathers, fewer payloads live together and the peak is
    lower. The other tensors are those of one
    group's program, which run one after another on the compute stream:
    the float32 band, and beside it the larger of two sets that do not
    live together — the eager unpack's transient for ONE video (the bytes
    widened to int32, the integer pixels, their stack and the float copy:
    18 bytes a pixel; 8-bit is one cast), or the seven (N, W) line sets
    (the band kernel's three, their prior-masked copies, the raw
    centerline) with the scan's per-step inputs and outputs. Payload and
    band are padded to the longest video, so the count is
    ``n_videos * n_max`` frames.
    """
    v_group = -(-n_videos // max(1, n_groups))
    payload = n_videos * n_max * band_rows * (w * depth // 8)
    frames = v_group * n_max
    band_f32 = frames * band_rows * w * 4
    lines = 7 * frames * w * 4
    scan_steps = frames * (3 * 4 + 2) + frames * (4 + 2 + 4)
    unpack = n_max * band_rows * w * (4 if depth == 8 else 18)
    return payload + band_f32 + max(unpack, lines + scan_steps)


class _FusedMeta:
    """The slice of FrameProfiles ``_outputs_from_scan`` actually reads
    (``frame_indices.size`` and ``width``)."""

    def __init__(self, frame_indices: np.ndarray, width: int):
        self.frame_indices = frame_indices
        self.width = width


class _FusedResult:
    """DeviceScanResult-shaped holder for the fused program's one output."""

    def __init__(self, final_position):
        self.final_position = final_position


def _fused_program(payload, bgs, meta, cals, fpss, mds, width: int,
                   bit_depth: int, config: FlameDetectorConfig, method: str,
                   use_frame_diff: bool) -> torch.Tensor:
    """The device program of one group, enqueued on the current stream.

    ``payload`` (V, L, B, row_nbytes) uint8 on the device; ``bgs`` the
    per-video backgrounds (host floats); ``meta`` (3, V, L) int32 on the
    device: frame indices, empty, has_prior. Returns ``final_position``
    (V, L) int32 — nothing else leaves the program.
    """
    from ..kernels.preprocess import band_to_profiles
    from ..kernels.unpack import _UNPACKERS
    from .cuda_scan import cuda_tracking_scan
    from .device_scan import tracking_scan_plain
    from .scan import scan_params

    dev = payload.device
    V, L, B = payload.shape[:3]
    # Unpack video by video into that video's slice of the one band: the
    # eager unpack's int32 and stacked copies are then one video's.
    band = torch.empty((V, L, B, width), dtype=torch.float32, device=dev)
    unpack = _UNPACKERS[bit_depth]
    for i in range(V):
        torch.sub(unpack(payload[i]), float(bgs[i]), out=band[i])
    band.clamp_min_(0.0)
    # Frame j's differencing prior is frame j-1 of the SAME video (j=0 has
    # none). Rows past a video's true length are scan-masked (`empty`), so
    # their profile values are never read.
    flat_idx = torch.arange(V * L, dtype=torch.int32, device=dev)
    prior = torch.where(flat_idx % L > 0, flat_idx - 1, -1).to(torch.int32)
    sob, grad, intens = band_to_profiles(
        band.view(V * L, B, width), prior,
        float(np.float32(config.frame_diff_threshold)),
        config.morphology_kernel_size, config.gaussian_sigma,
    )
    if method == "combined":
        sob, grad = sob.view(V, L, width), grad.view(V, L, width)
        intens_sel = None
    else:
        sob = grad = None
        if use_frame_diff:
            intens_sel = intens.view(V, L, width)
        else:
            margin = (B - 1) // 2
            intens_sel = band[:, :, margin, :].contiguous()  # raw centerline
    del band, intens
    params = scan_params(config, 1.0, 1.0, method)
    params.update(calibration=cals, frame_rate=fpss, max_displacement_px=mds)
    scan = tracking_scan_plain if dev.type == "cpu" else cuda_tracking_scan
    res = scan(meta[0], sob, grad, meta[1] != 0, meta[2] != 0, width=width,
               intensity_lines=intens_sel, **params)
    return res.final_position


def track_uniform_videos_fused(
    videos,
    w: int,
    config: FlameDetectorConfig,
    source_config: Optional[VideoSourceConfig],
    use_absolute_time: bool,
    stage_times=None,
    device=None,
    mesh=None,
) -> Optional[List["TrackingOutput"]]:  # noqa: F821 — runtime import below
    """Fused library tracking for a uniform-shape video group on ``device``
    (``None`` means ``cuda``), or on the 'video' slots of ``mesh``.

    Returns the per-video :class:`TrackingOutput` list (identical to the
    serial host scan), or ``None`` when the group doesn't satisfy the fast
    path's preconditions — the caller then uses the general chunked path:

    - every video exposes the packed BAND staging path + native counts
      (byte-aligned rows, a supported bit depth) at one (H, W, depth);
    - no per-video skip lists;
    - no even morphology kernel over a folding band;
    - :func:`_fused_budget_bytes` fits the device budget
      (:func:`_fused_limit_bytes`), summed over the slots of each card;
    - ``HSIP_FUSED`` is not ``0``.

    Each slot's videos are split into G pipelined groups
    (:func:`_fused_group_count`): each group is gathered, copied and
    enqueued before the next group's gather starts (round robin over the
    slots), and results are fetched only after every group is enqueued.
    Per-video results are independent, so grouping is output-invariant by
    construction.

    Videos with dark preambles/tails skip the transfer and the device work
    for their empty ranges (the empty-range clip — :func:`_clip_ranges`).
    The counts of a video are known when its gather lands, and a range of
    its pinned slice is contiguous, so the clip is decided after the
    group's gathers and before its copies, and only the ranges are copied:
    no host copy is made for it. Outputs stay bit-identical because the
    scan hard-gates empty rows.

    ``stage_times`` stages: ``read_gather`` in the gather threads; on the
    calling thread
    ``pool_take`` (the group's staging buffer), ``gather_wait`` (the wait
    for the group's gathers, with their pools), ``group_meta`` (the scan
    metadata and the clip's ranges), ``h2d``, ``device_dispatch``, ``d2h``,
    ``tables``. Host time under ``h2d`` and ``device_dispatch`` is only the
    enqueue, plus, under ``h2d``, the wait for the group's copy event; the
    wait for the device lands in ``d2h``. Counters: ``frames_staged`` (the
    frames of every group), ``frames_copied`` (the rows copied to the
    device after the clip), ``clipped_groups``, and from the gather threads
    ``frames_counted`` and ``frames_counted_vector``
    (:func:`count_fused_frames`) and ``frames_count_capped``: the frames
    whose count stopped before their last row at the cap of
    :func:`empty_count_cap`.
    """
    from ..kernels.cuda_preprocess import cuda_band_profiles
    from ..kernels.preprocess import band_folds, band_margin, reflect_indices
    from ..parallel.mesh import slot_shards
    from ..utils.backend import resolve_device
    from ..utils.profiling import StageTimes
    from . import batch as _batch
    from .cuda_scan import cuda_tracking_scan
    from .scan import MIN_SIGNAL_FRACTION, NOISE_THRESHOLD_FLOOR

    slots = [resolve_device(device)] if mesh is None else mesh.slots("video")
    if os.environ.get("HSIP_FUSED", "1") == "0":
        return None
    if source_config is not None and tuple(source_config.skip_frames):
        return None
    method = source_config.detection_method if source_config else "combined"
    use_frame_diff = source_config.use_frame_diff if source_config else True

    staging = []
    shape0 = videos[0].frame_shape
    for v in videos:
        if v.frame_shape != shape0 or len(v) == 0:
            return None
        _read_packed, read_band, _count_fn, depth = v.staging_paths()
        if read_band is None:
            return None
        staging.append(depth)
    depth0 = staging[0]
    if any(d != depth0 for d in staging):
        return None
    h = shape0[0]
    margin = band_margin(config.morphology_kernel_size, config.gaussian_sigma)
    # Even morphology windows do not commute with a folding reflect band:
    # that configuration needs the float64 host ops, which only the
    # general chunked path routes to.
    if config.morphology_kernel_size % 2 == 0 and band_folds(
        h // 2, margin, h
    ):
        return None
    V = len(videos)
    n_max = max(len(v) for v in videos)
    B = 2 * margin + 1
    shards = slot_shards(slots, V)
    need: dict = {}
    for slot, idxs in shards:
        need[slot] = need.get(slot, 0) + _fused_budget_bytes(
            len(idxs), n_max, w, B, depth0, _fused_group_count(len(idxs)))
    if any(n > _fused_limit_bytes(card) for card, n in need.items()):
        return None

    if stage_times is None:
        stage_times = StageTimes()

    rows = reflect_indices(h // 2, margin, h)
    rnb = w * depth0 // 8
    # The counts decide only `empty` below, so each stops at the cap.
    cap = empty_count_cap(h * w, MIN_SIGNAL_FRACTION)
    if cap is None:  # no count makes a frame non-empty: count exactly
        cap = np.iinfo(np.int32).max
    on_card = slots[0].type == "cuda"

    def _stage_dispatch_group(group: List[int], dev: torch.device,
                              slot: int) -> dict:
        """Gather, copy and ENQUEUE one video group on slot ``slot``'s
        device ``dev``; no result fetch.

        Returns everything :func:`_finish_group` needs. On return the
        group's copies have completed (their event is waited for), so the
        pinned buffer is idle and the caller may immediately stage the
        next group — which is the pipelining: this group's program runs on
        the device while the next group gathers on the host.
        """
        trace = {"gather_start_t": time.perf_counter(), "slot": slot,
                 "device": str(dev)}
        g_videos = [videos[i] for i in group]
        Vg = len(g_videos)

        # --- host staging: EVERY video gathers straight into its slice of
        # ONE pooled (Vg, n_max, B, row_nbytes) buffer (the native gather's
        # `out` path — zero intermediate copies). Rows past a video's
        # length may hold stale bytes, which is safe — the scan hard-gates
        # every masked step on `empty`, so masked profile values are never
        # consumed.
        with stage_times.stage("pool_take"):
            big_t = take_staging((Vg, n_max, B, rnb), pinned=on_card)
        big = big_t.numpy()
        bgs = np.zeros(Vg, np.float32)
        counts_done = [None] * Vg

        def _gather_one(i):
            video = g_videos[i]
            n = len(video)
            with stage_times.stage("read_gather"):
                bg = float(np.max(video[0]))
                bgs[i] = bg
                noise = max(NOISE_THRESHOLD_FLOOR, bg * 0.5)
                # Band rows AND counts in ONE sweep over the packed
                # payload, each frame's count stopped at the cap. The
                # video's copy of the original's code has no capped entry.
                _band, counts_done[i], stopped = (
                    video._require_reader().band_bytes_and_capped_counts(
                        0, n, rows, bg, noise, cap, out=big[i, :n]))
                count_fused_frames(stage_times, n, depth0)
                stage_times.count("frames_count_capped", stopped)

        # The gathers run in worker threads, whose ranges a profiler does
        # not keep: the main thread's wait (pools and all) is the span.
        with stage_times.stage("gather_wait"), ThreadPoolExecutor(
                max_workers=_gather_workers(Vg)) as gather_pool:
            for fut in [gather_pool.submit(_gather_one, i) for i in range(Vg)]:
                fut.result()
        trace["gather_end_t"] = time.perf_counter()

        # --- host-side scan metadata and the clip's ranges ---
        with stage_times.stage("group_meta"):
            fidx = np.zeros((Vg, n_max), np.int32)
            empty = np.ones((Vg, n_max), bool)
            has_prior = np.ones((Vg, n_max), bool)
            cals = np.ones(Vg, np.float32)
            fpss = np.ones(Vg, np.float32)
            mds = np.ones(Vg, np.int32)
            calibs: List[Tuple[float, float]] = []
            profiles_meta = []
            for i, video in enumerate(g_videos):
                n = len(video)
                fidx[i, :n] = np.arange(n, dtype=np.int32)
                fidx[i, n:] = n + np.arange(n_max - n, dtype=np.int32)
                counts = np.asarray(counts_done[i], dtype=np.int64)
                empty[i, :n] = counts / float(h * w) < MIN_SIGNAL_FRACTION
                # First processed frame has no differencing prior. Named
                # methods on raw profiles need no prior at all.
                if method == "combined" or use_frame_diff:
                    has_prior[i, 0] = False
                if source_config is not None:
                    cal, off = source_config.get_calibration_for_file(
                        video.filepath.name
                    )
                else:
                    cal, off = 1.0, 0.0
                calibs.append((cal, off))
                cals[i] = cal
                fpss[i] = video.frame_rate
                mds[i] = FlameTracker(
                    config, video.frame_rate, cal
                ).max_displacement_px
                profiles_meta.append(_FusedMeta(fidx[i, :n], w))

            # --- empty-range clip: copy only each video's
            # [first_nonempty-1, last] range (the -1 keeps the first
            # signal frame's differencing prior in-range) and scatter the
            # scan outputs back to full length on the host. Rows outside
            # the range are empty by definition — the scan hard-gates
            # them, so outputs are bit-identical.
            lengths = [len(v) for v in g_videos]
            clip = _clip_ranges(empty, lengths, n_max)
            if clip is not None:
                lo, L_each, L = clip
                fidx_s = np.zeros((Vg, L), np.int32)
                fidx_s[:] = n_max + np.arange(L, dtype=np.int32)
                empty_s = np.ones((Vg, L), bool)
                prior_s = np.ones((Vg, L), bool)
                for i in range(Vg):
                    li = L_each[i]
                    if li == 0:
                        continue
                    fidx_s[i, :li] = fidx[i, lo[i]:lo[i] + li]
                    fidx_s[i, li:] = fidx_s[i, li - 1] + np.arange(
                        1, L - li + 1, dtype=np.int32
                    )
                    empty_s[i, :li] = empty[i, lo[i]:lo[i] + li]
                    prior_s[i, :li] = has_prior[i, lo[i]:lo[i] + li]
                    if lo[i] > 0 and (method == "combined" or use_frame_diff):
                        # The clip's row 0 is an empty frame whose profile
                        # is never read; mark it prior-less like row 0 of a
                        # full run (the program derives the actual
                        # differencing prior from array position).
                        prior_s[i, 0] = False
            else:
                lo, L_each = np.zeros(Vg, np.int64), np.asarray(lengths)
                L = n_max
                fidx_s, empty_s, prior_s = fidx, empty, has_prior
        stage_times.count("frames_staged", sum(lengths))
        stage_times.count("frames_copied", int(np.sum(L_each)))
        stage_times.count("clipped_groups", int(clip is not None))

        # --- transfer: each video's range, from its pinned slice, on the
        # copy stream; the event after the last copy gates the compute
        # stream. The payload is allocated on the copy stream and used on
        # the compute stream, hence record_stream.
        meta_h = torch.empty((3, Vg, L), dtype=torch.int32, pin_memory=on_card)
        meta_np = meta_h.numpy()
        meta_np[0], meta_np[1], meta_np[2] = fidx_s, empty_s, prior_s
        with stage_times.stage("h2d"):
            if on_card:
                compute = torch.cuda.current_stream(dev)
                copies = _copy_stream(dev)
                with torch.cuda.stream(copies):
                    payload = torch.empty((Vg, L, B, rnb), dtype=torch.uint8,
                                          device=dev)
                    for i in range(Vg):
                        li = int(L_each[i])
                        if li:
                            payload[i, :li].copy_(
                                big_t[i, int(lo[i]):int(lo[i]) + li],
                                non_blocking=True,
                            )
                    copied = torch.cuda.Event()
                    copied.record(copies)
                payload.record_stream(compute)
                compute.wait_event(copied)
                meta = meta_h.to(dev, non_blocking=True)
            else:
                copied = None
                payload = torch.empty((Vg, L, B, rnb), dtype=torch.uint8)
                for i in range(Vg):
                    li = int(L_each[i])
                    payload[i, :li] = big_t[i, int(lo[i]):int(lo[i]) + li]
                meta = meta_h

        trace["dispatch_t"] = time.perf_counter()
        launched = (cuda_band_profiles.launches, cuda_tracking_scan.launches)
        with stage_times.stage("device_dispatch"):
            finals_dev = _fused_program(
                payload, bgs, meta, cals, fpss, mds, w, depth0, config,
                method, use_frame_diff,
            )
            trace["launches"] = (cuda_band_profiles.launches - launched[0],
                                 cuda_tracking_scan.launches - launched[1])
            del payload, meta
            if on_card:
                # The one fetch of the group, enqueued behind its program;
                # _finish_group waits for its event.
                finals = torch.empty((Vg, L), dtype=torch.int32,
                                     pin_memory=True)
                finals.copy_(finals_dev, non_blocking=True)
                fetched = torch.cuda.Event()
                fetched.record(compute)
                del finals_dev
            else:
                finals, fetched = finals_dev, None
        if copied is not None:
            # The pinned buffer is read by the copies until their event has
            # completed; the program itself keeps running on the device
            # while the host moves on.
            with stage_times.stage("h2d"):
                copied.synchronize()
        release_staging(big_t, copied)
        trace["inputs_ready_t"] = time.perf_counter()
        _LAST_PIPELINE_TRACE.append(trace)

        return {
            "first": group[0],
            "finals": finals,
            "fetched": fetched,
            "videos": g_videos,
            "profiles_meta": profiles_meta,
            "fidx": fidx,
            "empty": empty,
            "calibs": calibs,
            "clip": clip,
            "trace": trace,
        }

    def _finish_group(rec) -> List:
        with stage_times.stage("d2h"):
            if rec["fetched"] is not None:
                rec["fetched"].synchronize()
            fin = rec["finals"].numpy()
        clip = rec["clip"]
        if clip is not None:
            # Scatter the clipped scan outputs back to full length so
            # every downstream consumer (float64 reconstruction,
            # truncation, empty counting) sees exactly the arrays an
            # unclipped run produces.
            lo, L_each, _L = clip
            full = np.full((len(rec["videos"]), n_max), -1, np.int32)
            for i in range(len(rec["videos"])):
                li = int(L_each[i])
                if li:
                    full[i, lo[i]:lo[i] + li] = fin[i, :li]
            fin = full
        outs = _batch._outputs_from_scan(
            _FusedResult(fin), rec["videos"], rec["profiles_meta"],
            rec["fidx"], rec["empty"], rec["calibs"], use_absolute_time,
            config, stage_times=stage_times,
        )
        rec["trace"]["finals_ready_t"] = time.perf_counter()
        return outs

    _LAST_PIPELINE_TRACE.clear()

    slot_groups = []  # per slot: its pipelined groups of video indices
    for slot, idxs in shards:
        g = _fused_group_count(len(idxs))
        bounds = np.linspace(0, len(idxs), g + 1).astype(int)
        slot_groups.append([idxs[bounds[i]:bounds[i + 1]]
                            for i in range(g) if bounds[i + 1] > bounds[i]])

    # The pipeline: stage+enqueue every group back to back, round robin
    # over the slots (group g's program runs under the next group's host
    # gather), then fetch results in video order — the only blocking
    # device waits of the whole call.
    pending = [
        _stage_dispatch_group(groups[r], shards[s][0], s)
        for r in range(max(len(groups) for groups in slot_groups))
        for s, groups in enumerate(slot_groups) if r < len(groups)
    ]
    outputs: List = []
    for rec in sorted(pending, key=lambda rec: rec["first"]):
        outputs.extend(_finish_group(rec))
    return outputs
