"""``pipeline.self_ms_per_rec``: the source drivers' own time (discovery,
ledger, open, calibration lookup, table writer) a recording: the walls of
the window's calls minus the span of the tracking function they call
(harness spans), over the recordings completed."""


def read(record):
    calls = record.get("calls")
    tracking = record.get("tracking_s")
    if not calls or tracking is None or tracking <= 0:
        return None
    recordings = sum(c["recordings"] for c in calls)
    return (sum(c["wall_s"] for c in calls) - tracking) / recordings * 1e3
