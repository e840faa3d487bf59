"""Tokens recomputed after a preemption (EngineStats.recomputed_tokens)
over tokens emitted, in percent, over the window's steps."""


def read(rec):
    emitted = sum(s.emitted for s in rec.window_steps)
    if not emitted:
        return None
    return 100.0 * sum(s.recomputed for s in rec.window_steps) / emitted
