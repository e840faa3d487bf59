"""The whole step's share of the chip's bfloat16 peak in the batch cell:
model FLOPs of the useful tokens the window's steps processed (prompt
positions fed, tokens emitted, each with its attention over the keys it
sees) over the steps' summed host wall times the peak, in percent
(profiled steps left out)."""

import flops


def read(rec):
    wall = sum(s.wall for s in rec.steps)
    if wall <= 0:
        return None
    work = sum(rec.work.step_flops(rec.model, s.prefill, s.decode)
               for s in rec.steps)
    return 100.0 * work / (wall * flops.PEAK_FLOPS)
