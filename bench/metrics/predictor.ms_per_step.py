"""Host milliseconds in the predictor's initial, on_prefill and on_token
per step that ran in the window (profiled steps left out)."""


def read(rec):
    steps = rec.steps
    if not steps:
        return None
    return 1e3 * sum(s.predictor_s for s in steps) / len(steps)
