"""Closed-loop client pools: think-time users driving engines or servers.

The open-loop side of the repo (``repro_torch.traces``, the workload
scenarios) fixes every arrival time in advance. This package is the
reactive counterpart the paper's interactive setting implies: each
simulated user issues a request, *waits* for it to finish (or time out,
or be shed), thinks for a while, and only then issues the next — so the
offered load self-throttles with system latency. Two runners share one
config and one record format: `run_closed_loop` steps an in-process
engine on its virtual clock (deterministic, benchmark-grade), and
`run_live_pool` speaks HTTP/SSE to a live `repro_torch.server` front
door over real sockets (wall-clock, smoke/integration-grade).

A copy of the reference package's ``clients``: with the same seed the
closed loop gives the same `PoolStats.summary()`, byte for byte.
"""

from repro_torch.clients.live import run_live_pool
from repro_torch.clients.pool import (
    ClientPoolConfig,
    ClientRecord,
    PoolStats,
    run_closed_loop,
)

__all__ = [
    "ClientPoolConfig",
    "ClientRecord",
    "PoolStats",
    "run_closed_loop",
    "run_live_pool",
]
