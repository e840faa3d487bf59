"""Multi-replica cluster serving: a router over N engines.

A `Router` dispatches a shared arrival stream across N independent
`Engine` replicas in virtual time. The paper evaluates SPRPT-LP on a single instance; its companion work
(Mitzenmacher & Shahout, arXiv:2503.07545) frames prediction-based
scheduling as a multi-server queueing problem. This package supplies the
multi-server half: `Router` (dispatch policies, including
join-shortest-predicted-work over live TRAIL predictions) and
`run_cluster` (the `run_policy` analogue for N replicas).

A copy of the reference package's ``cluster``: in sim mode the same
arrival stream gives the same dispatch log and `ClusterStats`, byte for
byte; `faults` is pure Python, its grammar and messages unchanged.
"""

from repro_torch.cluster.router import (ROUTER_POLICIES, ClusterStats,
                                        Router, RouterConfig, run_cluster)

__all__ = ["ROUTER_POLICIES", "ClusterStats", "Router", "RouterConfig",
           "run_cluster"]
