"""Host milliseconds of the program's model.ssm_prefill spans (the enqueue
of each Mamba-2 mixer of a prefill chunk) per prefill chunk, mean over the
window's steps outside the profiler that prefilled and captured no graph
(a traced run's spans); nothing where the program opens no such span."""


def read(rec):
    steps = [s for s in rec.steps if "engine.prefill" in s.spans
             and "model.graph_capture" not in s.spans]
    if not any("model.ssm_prefill" in s.spans for s in steps):
        return None
    ns = sum(s.spans.get("model.ssm_prefill", {}).get("total_ns", 0)
             for s in steps)
    return 1e-6 * ns / sum(s.spans["engine.prefill"]["count"] for s in steps)
