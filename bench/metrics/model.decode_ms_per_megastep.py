"""Milliseconds between CUDA events recorded before and after each
Model.decode_multi call, mean over the window's calls (profiled steps left
out)."""


def read(rec):
    ms = [s.decode_ms for s in rec.steps if s.decode_ms is not None]
    return sum(ms) / len(ms) if ms else None
