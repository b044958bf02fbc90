"""``staging.count_capped_share``: the frames whose above-noise count the
fused library's gather stopped before their last row, at the least count
that makes a frame non-empty (``count.frames_count_capped``), over the
frames the fused gather+count pass counted (``count.frames_counted``),
program counters in the ``StageTimes`` handed to the tracking function.
None where the program keeps no such counter."""


def read(record):
    stages = record.get("stages") or {}
    counted = stages.get("count.frames_counted")
    capped = stages.get("count.frames_count_capped")
    if not counted or capped is None:
        return None
    return capped / counted
