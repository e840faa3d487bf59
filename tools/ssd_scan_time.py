"""Time the ``ssd_scan`` kernel at granite-4.0-h-small's prefill shapes and
hold each time against the bound of the tokens the rows hold.

    python3 tools/ssd_scan_time.py

from the root of a checkout, on a machine with an NVIDIA card. The engine
prefills a chunk over all 64 rows of the batch, 128 heads of 64 and a
state of 128 in bfloat16, while a chat chunk holds tokens in a few rows
(dt is 0 past each row's valid prefix). For each case it prints one JSON
line: the mean time of 20 launches (CUDA events, after 3 warm-up
launches) and the bound: the larger of the bytes the valid tokens need
(x, B, C and dt read, y written; the state read and written for each row
that holds a token) over 3.35 TB/s and their operations (4 * d_in * N a
token: the state's update and its read) over 989 TFLOP/s.
"""

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.kernels import ops  # noqa: E402

B, NH, HP, N = 64, 128, 64, 128
HBM_BW, PEAK_FLOPS = 3.35e12, 989e12
#: (chunk width, SSD chunk, valid tokens of the rows that hold any)
CASES = ((64, 64, [44, 20]), (64, 64, [44]), (256, 128, [200, 44]),
         (64, 64, [44] * B))


def case(L: int, chunk: int, valid: list) -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(L)
    x = torch.randn((B, L, NH, HP), device=dev, generator=g).bfloat16()
    Bm = torch.randn((B, L, N), device=dev, generator=g).bfloat16()
    Cm = torch.randn((B, L, N), device=dev, generator=g).bfloat16()
    dt = torch.rand((B, L, NH), device=dev, generator=g) * 0.5
    mask = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for r, n in enumerate(valid):
        mask[r, :n] = True
    dt = torch.where(mask[..., None], dt, 0.0).contiguous()
    A = -torch.rand(NH, device=dev, generator=g) - 0.5
    s0 = torch.randn((B, NH, HP, N), device=dev, generator=g) * 0.1
    for _ in range(3):
        ops.ssd_scan(x, dt, A, Bm, Cm, s0, chunk=chunk)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    n = 20
    e0.record()
    for _ in range(n):
        ops.ssd_scan(x, dt, A, Bm, Cm, s0, chunk=chunk)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / n
    tok, rows = sum(valid), sum(1 for v in valid if v)
    nbytes = tok * (NH * HP * 2 + 2 * N * 2 + NH * 4 + NH * HP * 4) + \
        rows * 2 * NH * HP * N * 4
    flops = 4.0 * NH * HP * N * tok
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_FLOPS
    bound = 1e3 * max(t_bytes, t_ops)
    return {"width": L, "chunk": chunk, "rows": rows, "tokens": tok,
            "ms": ms, "bound_ms": bound, "share_pct": 100 * bound / ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card: nothing to time", file=sys.stderr)
        return 2
    print(json.dumps({"gpu": torch.cuda.get_device_name(0)}))
    for L, chunk, valid in CASES:
        print(json.dumps(case(L, chunk, valid)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
