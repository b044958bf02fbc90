"""``parallel.rank_ms_per_rec``: a rank's own time in its library pass a
recording it was given: every rank's driver wall (``bench.rank_pass``,
which the route adds) less its waits for the others (the program's
``rank_wait``), over the recordings the ranks were given (the program's
``count.rank_recordings``), all ranks' ``StageTimes`` summed. The cost of
one recording on a rank that shares the host and the card with the
others. None where the program keeps no such counter."""


def read(record):
    stages = record.get("stages") or {}
    given = stages.get("count.rank_recordings")
    passes = stages.get("bench.rank_pass")
    if not given or not passes:
        return None
    return (passes - stages.get("rank_wait", 0.0)) / given * 1e3
