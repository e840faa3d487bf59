"""Host milliseconds of each step with nothing of the step's own on the
device: the program's engine.step span less the engine.prefill,
engine.decode and engine.fetch spans inside it, mean over the window's
steps outside the profiler (a traced run's spans)."""

#: the device calls and the waits for their outputs inside engine.step
DEVICE_PARTS = ("engine.prefill", "engine.decode", "engine.fetch")


def read(rec):
    steps = [s for s in rec.steps if "engine.step" in s.spans]
    if not steps:
        return None
    ns = sum(s.spans["engine.step"]["total_ns"]
             - sum(s.spans.get(p, {}).get("total_ns", 0)
                   for p in DEVICE_PARTS)
             for s in steps)
    return 1e-6 * ns / len(steps)
