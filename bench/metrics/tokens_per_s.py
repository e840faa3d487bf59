"""All the work of the window over the whole window: prompt tokens
prefilled for the first time plus tokens emitted, in every step that
started in the window, over the time from the window's opening to the end
of its last step. Tokens recomputed after a preemption do not count."""


def read(rec):
    if not rec.window_steps or rec.window_s <= 0:
        return None
    work = sum(s.first_prompt + s.emitted for s in rec.window_steps)
    return work / rec.window_s
