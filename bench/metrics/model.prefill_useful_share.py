"""Positions that hold prompt tokens over positions a prefill chunk
computes (every row of the batch times the chunk width), in percent, over
the window's chunks: an exact count."""


def read(rec):
    held = sum(n for s in rec.window_steps for _, n in s.prefill)
    computed = sum(s.rows * s.width for s in rec.window_steps if s.prefill)
    return 100.0 * held / computed if computed else None
