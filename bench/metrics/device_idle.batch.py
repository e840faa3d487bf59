"""Share of the time inside the profiled steps of the batch cell in which no
activity ran on the device, in percent."""


def read(rec):
    return rec.timeline.idle_share() if rec.timeline else None
