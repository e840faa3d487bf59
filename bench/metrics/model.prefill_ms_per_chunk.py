"""Milliseconds between CUDA events recorded before and after each
Model.prefill_chunk call, mean over the window's calls (profiled steps
left out)."""


def read(rec):
    ms = [s.prefill_ms for s in rec.steps if s.prefill_ms is not None]
    return sum(ms) / len(ms) if ms else None
