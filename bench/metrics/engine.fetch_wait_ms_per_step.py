"""Host milliseconds in the program's engine.fetch spans (each ``.cpu()``
of the device's outputs: the host waiting on the device) per step, mean
over the window's steps outside the profiler (a traced run's spans)."""


def read(rec):
    steps = [s for s in rec.steps if "engine.step" in s.spans]
    if not steps:
        return None
    return 1e-6 * sum(s.spans.get("engine.fetch", {}).get("total_ns", 0)
                      for s in steps) / len(steps)
