"""``fused.group_meta_ms_per_rec``: the program's ``group_meta`` stage
(the library group's host-side scan metadata, calibration lookup and the
empty-range clip's ranges) a recording completed in the window, from
``StageTimes``."""


def read(record):
    stages = record.get("stages") or {}
    calls = record.get("calls")
    if "group_meta" not in stages or not calls:
        return None
    return stages["group_meta"] / sum(c["recordings"] for c in calls) * 1e3
