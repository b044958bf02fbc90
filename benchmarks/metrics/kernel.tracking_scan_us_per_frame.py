"""``kernel.tracking_scan_us_per_frame``: the tracking-scan kernel's device
time by name in the trace, over the frames of the recordings tracked in
the window (clipped frames included)."""

KERNEL = "tracking_scan_kernel"


def read(record):
    ops = record.get("device_ops") or {}
    calls = record.get("calls")
    seconds = sum(v["seconds"] for k, v in ops.items() if KERNEL in k)
    if not calls or seconds <= 0:
        return None
    return seconds / sum(c["frames"] for c in calls) * 1e6
