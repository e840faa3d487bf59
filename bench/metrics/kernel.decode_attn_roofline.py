"""Share of its roofline the paged single-query attention kernel reached
in the profiled steps: the K/V bytes the active rows' contexts need, with
their queries and outputs, at the chip's HBM bandwidth, over the summed
device time of the kernel's launches."""

import flops

KERNELS = ("decode_kernel",)


def read(rec):
    tl = rec.timeline
    if tl is None:
        return None
    busy = tl.kernel_s(KERNELS)
    if not busy:
        return None
    nbytes = sum(rec.work.decode_attn_bytes(rec.model, keys + t)
                 for s in rec.traced for keys, n in s.decode
                 for t in range(n))
    return 100.0 * (nbytes / flops.HBM_BW) / busy
