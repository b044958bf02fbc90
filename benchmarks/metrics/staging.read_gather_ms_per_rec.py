"""``staging.read_gather_ms_per_rec``: the program's ``read_gather`` stage
(host band gather and above-noise counts) a recording completed in the
window, from the ``StageTimes`` handed to the tracking function."""


def read(record):
    stages = record.get("stages") or {}
    calls = record.get("calls")
    if "read_gather" not in stages or not calls:
        return None
    return stages["read_gather"] / sum(c["recordings"] for c in calls) * 1e3
