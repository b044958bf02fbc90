"""``track.tables_ms_per_rec``: the program's ``tables`` stage (rows,
float64 velocities, DDT and stop decisions from the scan's positions) a
recording completed in the window, from ``StageTimes``."""


def read(record):
    stages = record.get("stages") or {}
    calls = record.get("calls")
    if "tables" not in stages or not calls:
        return None
    return stages["tables"] / sum(c["recordings"] for c in calls) * 1e3
