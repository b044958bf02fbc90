"""``parallel.rank_wait_ms_per_call``: the ranks' ``rank_wait`` stage
(their waits in the source ledger's barriers for the other ranks: after
ledger set-up and at the end of the pass), summed over every rank's
``StageTimes``, over the window's calls. None where the program has no
such stage (no processor, or a program that does not time it)."""


def read(record):
    stages = record.get("stages") or {}
    calls = record.get("calls")
    if "rank_wait" not in stages or not calls:
        return None
    return stages["rank_wait"] / len(calls) * 1e3
