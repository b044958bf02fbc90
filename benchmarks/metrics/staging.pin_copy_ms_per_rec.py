"""``staging.pin_copy_ms_per_rec``: the program's ``pin_copy`` stage (the
per-file staging's host copy of the gathered band into a pinned buffer,
inside ``h2d``) a recording completed in the window, from
``StageTimes``."""


def read(record):
    stages = record.get("stages") or {}
    calls = record.get("calls")
    if "pin_copy" not in stages or not calls:
        return None
    return stages["pin_copy"] / sum(c["recordings"] for c in calls) * 1e3
