"""Host milliseconds in the engine's select_batch per step that ran in the
window (profiled steps left out)."""


def read(rec):
    steps = rec.steps
    if not steps:
        return None
    return 1e3 * sum(s.select_s for s in steps) / len(steps)
