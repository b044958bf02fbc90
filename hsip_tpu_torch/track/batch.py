"""Table reconstruction from device-scan positions (pure numpy).

Copies of :class:`hsip_tpu.track.batch.ScanHistory` and
:func:`hsip_tpu.track.batch.build_device_scan_output`: they are plain
numpy, but their original module imports JAX at its top. The scan emits
integer positions; the exit / velocity-drop truncation, the DDT latch and
the row labels are recomputed here in float64, exactly as the host scan
decides them.
"""

from __future__ import annotations

from .host_scan import TrackingOutput
from .velocity import (
    ddt_frame_from_velocities,
    iter_velocity_entries,
    velocities_from_positions,
)

__all__ = ["ScanHistory", "build_device_scan_output"]


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
