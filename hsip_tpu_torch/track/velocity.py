"""Exact float64 velocity reconstruction from integer positions.

Pure-Python / numpy-free helpers shared by the device scan, the collection
batch path and the (jax-free) visualization workers. Semantics mirror
:meth:`hsip_tpu.track.tracker.FlameTracker._update_velocities` exactly —
three finite-difference stencils with the central-difference retro-fill.
"""

from __future__ import annotations

__all__ = [
    "iter_velocity_entries",
    "velocity_entries_from_positions",
    "ddt_frame_from_velocities",
    "velocities_from_positions",
]

_NO_ENTRY = object()  # "no history entry yet" (distinct from pos=None)


def iter_velocity_entries(entries, frame_rate: float, calibration: float):
    """Incrementally apply the tracker's velocity-append rule.

    ``entries`` is an iterable of ``(frame_idx, pos_or_None)`` history
    entries in step order. After consuming each one, yields the growing
    velocity-entry list ``[[frame, v1, v2, vc], ...]`` — the SAME list
    object every time (the central-difference retro-fill mutates the
    previous entry in place). Lazy so a caller replaying per-step stop
    decisions can break without paying for the discarded tail: the kernels
    deliberately track past their advisory stop latches, and an early-exit
    video would otherwise compute float64 stencils over thousands of
    post-stop steps on the (slow) host.
    """
    vel = []  # [frame, v1, v2, vc]
    prev2 = prev1 = _NO_ENTRY
    for frame, pos in entries:
        if (
            pos is not None
            and prev1 is not _NO_ENTRY
            and prev1[1] is not None
            and frame_rate > 0
        ):
            dt = (frame - prev1[0]) / frame_rate
            if dt > 0:
                v1 = (pos - prev1[1]) * calibration / dt
                v2 = None
                if prev2 is not _NO_ENTRY and prev2[1] is not None:
                    p1, p2 = prev1[1], prev2[1]
                    v2 = (3 * pos - 4 * p1 + p2) * calibration / (2 * dt)
                    vc = (pos - p2) * calibration / (2 * dt)
                    if vel:
                        vel[-1][3] = vc
                vel.append([frame, v1, v2, None])
        prev2, prev1 = prev1, (frame, pos)
        yield vel


def velocity_entries_from_positions(entries, frame_rate: float, calibration: float):
    """Exact float64 velocity reconstruction from integer positions.

    ``entries`` is the ordered history [(frame_idx, pos_or_None), ...] of
    every tracker step that ran. Returns the ordered velocity-entry list
    [[frame, v1, v2, vc], ...] — identical to
    :meth:`FlameTracker.get_velocity_history`, including the
    central-difference retro-fill.
    """
    vel = []
    for vel in iter_velocity_entries(entries, frame_rate, calibration):
        pass
    return vel


def ddt_frame_from_velocities(vel_entries, jump_threshold: float):
    """First frame whose v1 jumps above the DDT threshold, or None."""
    for i in range(1, len(vel_entries)):
        if vel_entries[i][1] - vel_entries[i - 1][1] > jump_threshold:
            return vel_entries[i][0]
    return None


def velocities_from_positions(
    entries,
    frame_rate: float,
    calibration: float,
    clear_vc_entry: int = -1,
):
    """Dict form of :func:`velocity_entries_from_positions`: {frame:
    (v1, v2, vc)}, with the ``clear_vc_entry`` ordinal's central difference
    invalidated (the truncation-time ``clear_last_central_difference``)."""
    vel = velocity_entries_from_positions(entries, frame_rate, calibration)
    if clear_vc_entry >= len(vel):
        # The ordinal comes from the device scan's entry counter; running
        # past the host reconstruction means the two implementations
        # disagree about which steps appended entries — surface it rather
        # than silently keeping a v_central the reference would have nulled.
        raise AssertionError(
            f"clear_vc_entry {clear_vc_entry} out of range for "
            f"{len(vel)} velocity entries (host/device entry-count drift)"
        )
    if clear_vc_entry >= 0:
        vel[clear_vc_entry][3] = None
    return {e[0]: (e[1], e[2], e[3]) for e in vel}
