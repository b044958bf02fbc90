"""``clip.frames_copied_share``: the frames the library program copied to
the card after the empty-range clip (``count.frames_copied``) over the
frames its groups staged (``count.frames_staged``), program counters in
the ``StageTimes`` handed to the tracking function. 1.0 when no group
was clipped."""


def read(record):
    stages = record.get("stages") or {}
    staged = stages.get("count.frames_staged")
    if "count.frames_copied" not in stages or not staged:
        return None
    return stages["count.frames_copied"] / staged
