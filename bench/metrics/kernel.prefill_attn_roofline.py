"""Share of its roofline the paged multi-query (chunk) attention kernel
reached in the profiled steps: each layer's causal chunk-against-context
work of the rows that hold tokens, bounded by the larger of its FLOP and
byte bounds, over the summed device time of the kernel's launches."""

import flops

KERNELS = ("paged_multi",)


def read(rec):
    tl = rec.timeline
    if tl is None:
        return None
    busy = tl.kernel_s(KERNELS)
    if not busy:
        return None
    bound = 0.0
    for s in rec.traced:
        if not s.prefill:
            continue
        work = [rec.work.prefill_attn_work(rec.model, st, n)
                for st, n in s.prefill]
        bound += rec.work.attn_layers(rec.model) * flops.bound_s(
            sum(f for f, _ in work), sum(b for _, b in work))
    return 100.0 * bound / busy
