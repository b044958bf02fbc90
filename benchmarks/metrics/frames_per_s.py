"""``frames_per_s``: frames of every recording whose tables the window's
calls wrote, over the window (its start to the end of the last completed
call). Host clock."""


def read(record):
    calls = record.get("calls")
    if not calls or not record.get("window_s"):
        return None
    return sum(c["frames"] for c in calls) / record["window_s"]
