"""Host milliseconds the program's engine.decode span takes (the enqueue
of a decode megastep, which makes no sync), mean over the window's
megasteps outside the profiler (a traced run's spans)."""


def read(rec):
    got = [s.spans["engine.decode"] for s in rec.steps
           if "engine.decode" in s.spans]
    n = sum(g["count"] for g in got)
    return 1e-6 * sum(g["total_ns"] for g in got) / n if n else None
