"""Share of the time inside the profiled steps of a chat cell in which no
activity ran on the device, in percent."""


def read(rec):
    return rec.timeline.idle_share() if rec.timeline else None
