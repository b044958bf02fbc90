"""``device.idle_share``: 1 - the union of kernel, copy and fill intervals
in the trace (clipped to the window) over the window."""


def read(record):
    busy = record.get("busy_s")
    window = record.get("window_s")
    if not busy or not window:
        return None
    return 1.0 - busy / window
