"""``staging.gather_wait_ms_per_rec``: the program's ``gather_wait`` stage
(the library's main thread waiting for its gather threads, pool set-up
and join included) a recording completed in the window, from the
``StageTimes`` handed to the tracking function."""


def read(record):
    stages = record.get("stages") or {}
    calls = record.get("calls")
    if "gather_wait" not in stages or not calls:
        return None
    return stages["gather_wait"] / sum(c["recordings"] for c in calls) * 1e3
