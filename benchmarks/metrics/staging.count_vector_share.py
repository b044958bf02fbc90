"""``staging.count_vector_share``: the frames a vector path of the native
count covered (``count.frames_counted_vector``) over the frames the fused
gather+count pass counted (``count.frames_counted``), program counters in
the ``StageTimes`` handed to the tracking function. None where the program
keeps no such counters."""


def read(record):
    stages = record.get("stages") or {}
    counted = stages.get("count.frames_counted")
    if not counted:
        return None
    return stages.get("count.frames_counted_vector", 0) / counted
