"""Serving launcher (the reference ``repro.launch.serve``): run the TRAIL
engine, an N-replica cluster or the online front door over a workload.

    # paper-scale policy comparison under the roofline cost model
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --policy trail --rate 14 --n 300

    # named workload scenario (see serving/workload.py SCENARIOS)
    PYTHONPATH=src python -m repro_torch.launch.serve --scenario bursty \
        --rate 14

    # 2-replica cluster with predicted-work routing (sim)
    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 \
        --router jspw --scenario bursty --rate 2.0 --compute-bound

    # real end to end on the card (random weights from --seed), or on the
    # CPU with a smoke config
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --real --n 12
    PYTHONPATH=src python -m repro_torch.launch.serve --arch trail-llama \
        --smoke --real --n 6 --device cpu

    # replay the bundled Azure-style trace at 24x its native rate and
    # write the full percentile/SLO metrics report
    PYTHONPATH=src python -m repro_torch.launch.serve --trace sample \
        --rate-scale 24 --metrics-out metrics.json

    # tail-aware scheduling: the BENCH_tail recipe (rank aging + early
    # C-limit pin + paged KV)
    PYTHONPATH=src python -m repro_torch.launch.serve --trace sample \
        --rate-scale 24 --tail --metrics-out metrics.json

    # overload + failure resilience: deadlines, predicted-work load
    # shedding, and deterministic chaos with router failover
    PYTHONPATH=src python -m repro_torch.launch.serve --scenario bursty \
        --rate 40 --deadline 120 --shed-watermark 20000
    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 \
        --router jspw --scenario bursty --chaos crash:1@30-90 \
        --compute-bound

    # prefill/decode disaggregation: 1 prefill + 3 decode replicas with
    # paged KV-page shipping over a 25 GB/s interconnect
    PYTHONPATH=src python -m repro_torch.launch.serve --disagg 1:3 \
        --scenario bursty --rate 8 --compute-bound --link-gbps 25

    # online front door: HTTP/SSE server with continuous admission
    PYTHONPATH=src python -m repro_torch.launch.serve --serve --port 8100 \
        --shed-watermark 3000 --admission-control

    # live closed loop: 8 socket clients against the in-process server,
    # 20x time warp
    PYTHONPATH=src python -m repro_torch.launch.serve --serve --clients 8 \
        --think-time 1.0 --time-scale 20

    # deterministic in-process closed loop (virtual clock, no sockets)
    PYTHONPATH=src python -m repro_torch.launch.serve --clients 64 \
        --policy trail --think-time 2.0

Flags, defaults, help and every check that exits with status 2 are the
reference's, and in sim mode the printed JSON and the ``--metrics-out``
file are the reference CLI's byte for byte, cluster and closed-loop modes
included. ``--device`` (default ``cuda``) is the port's own: where
``--real`` runs the model. As in the reference, cluster mode and the
front door run sim engines only (``--real`` with ``--replicas``,
``--disagg``, ``--serve`` or ``--clients`` exits 2); a cluster of real
engines on the card is built through `repro_torch.cluster.Router`.
The latencies in the JSON come from the engine's cost model, whose default
``HardwareSpec()`` is a TPU v5e preset, in real mode too: they are not
times measured on the card. ``main(argv)`` runs in-process and returns
the stats (`EngineStats`, `ClusterStats` or the pool's `PoolStats`) and
the event log (None without ``--metrics-out``, outside the front door).
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import replace as dc_replace

from repro_torch.cluster import ROUTER_POLICIES, run_cluster
from repro_torch.cluster.faults import parse_chaos
from repro_torch.config import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.scheduler import POLICIES
from repro_torch.serving.costmodel import HardwareSpec
from repro_torch.serving.engine import run_policy
from repro_torch.serving.predictors import STRATEGIES, parse_spec
from repro_torch.serving.workload import (SCENARIOS, WorkloadConfig,
                                          generate, scenario_config)


def main(argv=None):
    """Parse CLI flags, build the workload, and run the engine/cluster."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b",
                    choices=ARCH_IDS + ("trail-llama",))
    ap.add_argument("--policy", default="trail", choices=POLICIES)
    ap.add_argument("--predictor", default=None, metavar="SPEC",
                    help="length-prediction strategy spec "
                         "'name[:key=value,...]' (names: "
                         f"{', '.join(STRATEGIES)}); sim mode only. "
                         "Default: the scenario's recommendation, else "
                         "the legacy trail probe. 'rank-only' pairs "
                         "with --policy rank (auto-selected when the "
                         "policy is left at its default)")
    ap.add_argument("--c", type=float, default=None,
                    help="preemption budget multiplier C (default 0.8; "
                         "--tail lowers it to 0.2)")
    ap.add_argument("--rate", type=float, default=None,
                    help="aggregate request rate (req/s; default 14, or "
                         "the trace's native rate with --trace)")
    ap.add_argument("--n", type=int, default=None,
                    help="request count (synthetic default: 300); with "
                         "--trace: cap on replayed records (default: the "
                         "whole trace)")
    ap.add_argument("--burst", action="store_true")
    ap.add_argument("--scenario", default=None, choices=sorted(SCENARIOS),
                    help="named workload scenario preset")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="replay a recorded trace (.jsonl/.csv, or "
                         "'sample' for the bundled Azure-style fixture) "
                         "instead of a synthetic scenario; --rate sets "
                         "the target mean arrival rate (0 = native)")
    ap.add_argument("--rate-scale", type=float, default=None,
                    help="trace replay: multiply the native arrival rate "
                         "(overrides the --rate-derived scale)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="capture the per-request event stream and write "
                         "the rollup (TTFT/TBT/completion percentiles + "
                         "SLO attainment) as JSON; also prints the "
                         "markdown table")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--mem-gb", type=float, default=0.0,
                    help="KV memory budget (0 = unlimited)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="cluster mode: number of replica engines (sim)")
    ap.add_argument("--router", default="jspw", choices=ROUTER_POLICIES,
                    help="cluster dispatch policy")
    ap.add_argument("--disagg", default=None, metavar="P:D",
                    help="prefill/decode disaggregation: P dedicated "
                         "prefill replicas + D decode replicas (implies "
                         "cluster mode with P+D replicas and --kv-layout "
                         "paged; finished prefills ship their KV pages "
                         "to a decode replica over the interconnect)")
    ap.add_argument("--link-gbps", type=float, default=None, metavar="GBPS",
                    help="replica<->replica interconnect bandwidth in "
                         "gigabytes/s for the KV handoff hop (default 25, "
                         "~200 Gb/s Ethernet); requires --disagg")
    ap.add_argument("--compute-bound", action="store_true",
                    help="compute-bound hardware point (2 TFLOP/s) where "
                         "routing quality is visible; default is tpu-v5e")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share identical KV prefixes across requests "
                         "(implies --kv-layout paged; pairs with the "
                         "shared-prefix scenario and the prefix-affinity "
                         "router)")
    ap.add_argument("--kv-layout", default=None,
                    choices=("contig", "paged"),
                    help="KV cache layout (default contig; --prefix-cache "
                         "forces paged)")
    ap.add_argument("--deadline", type=float, default=0.0, metavar="S",
                    help="per-request completion deadline (seconds after "
                         "arrival, engine clock); expired requests are "
                         "cancelled and count against goodput (0 = none)")
    ap.add_argument("--ttft-deadline", type=float, default=0.0, metavar="S",
                    help="first-token deadline (seconds after arrival); "
                         "requests still waiting past it are cancelled "
                         "(0 = none)")
    ap.add_argument("--shed-watermark", type=float, default=0.0,
                    metavar="TOKENS",
                    help="predicted-backlog watermark (tokens) above which "
                         "the engine sheds its worst-ranked waiting "
                         "requests (0 = shedding off)")
    ap.add_argument("--admission-control", action="store_true",
                    help="with --shed-watermark: refuse new arrivals at "
                         "admission while the predicted backlog is above "
                         "the watermark, instead of shedding queued work")
    ap.add_argument("--age-boost", type=float, default=None, metavar="R",
                    help="rank-aging boost: rank units (predicted tokens) "
                         "subtracted per second a request waits beyond "
                         "the --age-delay grace window; starvation-free "
                         "for any value > 0 (default 0 = off)")
    ap.add_argument("--age-delay", type=float, default=None, metavar="S",
                    help="rank-aging grace window (seconds): ordering "
                         "stays pure SRPT inside it (default 0)")
    ap.add_argument("--deadline-slack", type=float, default=None,
                    metavar="S",
                    help="deadline-aware limited preemption: a running "
                         "request within this many seconds of its "
                         "--deadline is never preempted (0 = off)")
    ap.add_argument("--tail", action="store_true",
                    help="apply the BENCH_tail recipe (age-boost 3072, "
                         "age-delay 20.5, c 0.2, paged KV): un-inverts "
                         "completion-p99 vs fcfs at overload while "
                         "keeping the >=1.5x mean win; explicit "
                         "--age-boost/--age-delay/--c/--kv-layout "
                         "flags override individual knobs")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault injection for cluster mode: "
                         "comma-separated crash:R@T[-U] | slow:R@T-U*F | "
                         "flaky:R@T-U%%P (e.g. 'crash:1@30,slow:0@10-20*4')")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="cluster failover: per-request retry budget "
                         "before a request is declared lost")
    ap.add_argument("--serve", action="store_true",
                    help="run the online front door: an asyncio HTTP/SSE "
                         "server that admits requests continuously into "
                         "the engine and streams tokens back (sim mode, "
                         "single engine; POST /v1/generate, GET /healthz, "
                         "GET /metrics)")
    ap.add_argument("--port", type=int, default=None,
                    help="front-door TCP port (default 8100; 0 = "
                         "OS-assigned; requires --serve)")
    ap.add_argument("--time-scale", type=float, default=None, metavar="X",
                    help="virtual seconds the engine clock advances per "
                         "wall second behind the front door (default 1.0 "
                         "= real time; requires --serve)")
    ap.add_argument("--clients", type=int, default=None, metavar="N",
                    help="closed-loop pool of N think-time users; with "
                         "--serve they drive the live server over "
                         "sockets, alone they drive the engine in-process "
                         "on its virtual clock (deterministic)")
    ap.add_argument("--think-time", type=float, default=None, metavar="S",
                    help="mean exponential think time between a user's "
                         "requests (default 2.0; requires --clients)")
    ap.add_argument("--requests-per-client", type=int, default=None,
                    metavar="K",
                    help="logical requests each user issues (default 4; "
                         "requires --clients)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--real", action="store_true",
                    help="actually run the model on --device (random "
                         "weights from --seed)")
    ap.add_argument("--device", default="cuda",
                    help="where --real runs the model (default cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rate = 14.0 if args.rate is None else args.rate
    # real mode shrinks lengths to CPU scale; with a --scenario preset the
    # arrival process is kept and only the length mix is downsized. The
    # tenant mix is dropped at this scale, so --prefix-cache keeps a small
    # single-tenant system prompt instead (one KV page at page_size=16) —
    # otherwise the downsizing would silently remove every shared prefix.
    real_sizes = dict(prompt_mean=10.0, out_median=8.0, max_out=32,
                      tenants=())
    if args.prefix_cache:
        real_sizes.update(prefix_len=16, split_streams=True)
    # CLI contract: every invalid flag combination or unusable input
    # exits 2 with a one-line error (argparse's own convention), never a
    # traceback or a status-1 SystemExit
    if args.rate_scale is not None:
        if not args.trace:
            ap.error("--rate-scale only applies to --trace replay "
                     "(use --rate for synthetic scenarios)")
        if args.rate_scale <= 0:
            ap.error("--rate-scale must be positive")
    if args.deadline < 0 or args.ttft_deadline < 0:
        ap.error("--deadline/--ttft-deadline must be >= 0")
    if args.shed_watermark < 0:
        ap.error("--shed-watermark must be >= 0")
    if args.admission_control and args.shed_watermark <= 0:
        ap.error("--admission-control requires --shed-watermark > 0 "
                 "(the watermark is the admission threshold)")
    for flag, val in (("--age-boost", args.age_boost),
                      ("--age-delay", args.age_delay),
                      ("--deadline-slack", args.deadline_slack)):
        if val is not None and val < 0:
            ap.error(f"{flag} must be >= 0")
    if args.deadline_slack and not args.deadline:
        ap.error("--deadline-slack requires --deadline > 0 (the slack "
                 "window is measured against the completion deadline)")
    # --tail supplies the BENCH_tail recipe as *defaults*; any knob the
    # user set explicitly wins over the recipe value
    age_boost = args.age_boost if args.age_boost is not None \
        else (3072.0 if args.tail else 0.0)
    age_delay = args.age_delay if args.age_delay is not None \
        else (20.5 if args.tail else 0.0)
    deadline_slack = args.deadline_slack or 0.0
    c_limit = args.c if args.c is not None else (0.2 if args.tail else 0.8)
    prefill_replicas = 0
    if args.disagg:
        try:
            p_str, d_str = args.disagg.split(":")
            p, d = int(p_str), int(d_str)
        except ValueError:
            ap.error("--disagg must be P:D with integer replica counts "
                     "(e.g. --disagg 1:3)")
        if p < 1 or d < 1:
            ap.error("--disagg needs at least one prefill and one decode "
                     "replica (P >= 1 and D >= 1)")
        if args.replicas > 1 and args.replicas != p + d:
            ap.error(f"--replicas {args.replicas} conflicts with "
                     f"--disagg {args.disagg} (= {p + d} replicas); "
                     "drop --replicas — --disagg sets the fleet size")
        if args.kv_layout == "contig":
            ap.error("--disagg requires a paged KV layout (pages are the "
                     "unit of handoff); drop --kv-layout contig")
        prefill_replicas = p
        args.replicas = p + d
    if args.link_gbps is not None:
        if not args.disagg:
            ap.error("--link-gbps only applies to --disagg (it sets the "
                     "KV handoff interconnect bandwidth)")
        if args.link_gbps <= 0:
            ap.error("--link-gbps must be positive")
    faults = None
    if args.chaos:
        if args.replicas <= 1:
            ap.error("--chaos requires cluster mode (--replicas >= 2): "
                     "fault injection and failover live in the router")
        try:
            faults = parse_chaos(args.chaos, seed=args.seed)
        except ValueError as e:
            ap.error(str(e))
    serve_mode = args.serve or args.clients is not None
    if args.port is not None:
        if not args.serve:
            ap.error("--port requires --serve (it binds the front-door "
                     "listener)")
        if not 0 <= args.port <= 65535:
            ap.error("--port must be in [0, 65535] (0 = OS-assigned)")
    if args.time_scale is not None:
        if not args.serve:
            ap.error("--time-scale requires --serve (the in-process "
                     "closed loop already runs on the virtual clock)")
        if args.time_scale <= 0:
            ap.error("--time-scale must be positive")
    if args.clients is not None and args.clients <= 0:
        ap.error("--clients must be a positive user count")
    if args.think_time is not None:
        if args.clients is None:
            ap.error("--think-time requires --clients (it is the pool's "
                     "mean think time)")
        if args.think_time < 0:
            ap.error("--think-time must be >= 0")
    if args.requests_per_client is not None:
        if args.clients is None:
            ap.error("--requests-per-client requires --clients")
        if args.requests_per_client <= 0:
            ap.error("--requests-per-client must be positive")
    if serve_mode:
        mode_flags = "--serve/--clients"
        for flag, bad in (("--trace", args.trace),
                          ("--scenario", args.scenario),
                          ("--burst", args.burst),
                          ("--disagg", args.disagg),
                          ("--chaos", args.chaos),
                          ("--real", args.real),
                          ("--metrics-out", args.metrics_out)):
            if bad:
                ap.error(f"{mode_flags} run a live closed loop over one "
                         f"sim engine and conflict with {flag} (the "
                         "clients are the workload; GET /metrics serves "
                         "the live rollup)")
        if args.replicas > 1:
            ap.error(f"{mode_flags} drive a single engine; the cluster "
                     "router is not behind the front door yet (drop "
                     "--replicas)")
        policy = args.policy
        pred_spec = args.predictor or ""
        if pred_spec:
            name = parse_spec(pred_spec)[0]
            if name not in STRATEGIES:
                ap.error(f"unknown predictor strategy {name!r}; "
                         f"choose from {STRATEGIES}")
            if name == "rank-only" and policy == "trail":
                policy = "rank"
        return _run_front_door(args, cfg, policy=policy,
                               pred_spec=pred_spec, c_limit=c_limit,
                               age_boost=age_boost, age_delay_s=age_delay,
                               deadline_slack_s=deadline_slack)
    if args.trace:
        if args.real:
            ap.error("--trace replay is sim-only (trace lengths "
                     "exceed CPU-sized device pools)")
        if args.scenario or args.burst:
            ap.error("--trace conflicts with --scenario/--burst: "
                     "a trace supplies its own arrivals and lengths")
        if args.trace != "sample" and not os.path.isfile(args.trace):
            ap.error(f"--trace path {args.trace!r} does not exist or is "
                     "not a file (pass 'sample' for the bundled fixture)")
        overrides = ({"trace_rate_scale": args.rate_scale}
                     if args.rate_scale is not None else {})
        # --n caps the replay; None/0 = the whole trace, never a silent
        # truncation to the synthetic default
        wc = scenario_config(f"trace:{args.trace}",
                             n_requests=args.n or 0,
                             request_rate=args.rate or 0.0, seed=args.seed,
                             vocab=cfg.vocab_size, **overrides)
    elif args.scenario:
        wc = scenario_config(args.scenario, n_requests=args.n or 300,
                             request_rate=rate, seed=args.seed,
                             vocab=cfg.vocab_size,
                             **(real_sizes if args.real else {}))
    else:
        wc = WorkloadConfig(n_requests=args.n or 300, request_rate=rate,
                            burst=args.burst, vocab=cfg.vocab_size,
                            seed=args.seed,
                            **(real_sizes if args.real else {}))
    reqs = generate(wc)
    if args.trace:
        # report the replayed stream's actual mean rate, not the
        # synthetic default (native trace rate x whatever scaling
        # applied); 0.0 = undefined (single request / zero span)
        span = (reqs[-1].arrival - reqs[0].arrival) if len(reqs) > 1 else 0.0
        rate = (len(reqs) - 1) / span if span > 0 else 0.0
    hardware = (HardwareSpec(name="compute-bound-2tf", peak_flops=2e12,
                             hbm_bw=819e9, overhead_s=2e-4)
                if args.compute_bound else HardwareSpec())
    if args.link_gbps is not None:
        hardware = dc_replace(hardware, link_bw=args.link_gbps * 1e9)
    mem_budget = int(args.mem_gb * 1e9) if args.mem_gb else 1 << 62
    kv_layout = args.kv_layout or ("paged" if args.prefix_cache or args.tail
                                   or args.disagg else "contig")

    # strategy resolution: explicit flag > scenario recommendation >
    # legacy default ("" = the engine's built-in trail probe)
    pred_spec = args.predictor if args.predictor is not None else wc.predictor
    policy = args.policy
    if pred_spec:
        if args.real:
            ap.error("--predictor strategies are sim-only; the "
                     "real engine uses the live ProbePredictor")
        name = parse_spec(pred_spec)[0]
        if name not in STRATEGIES:
            ap.error(f"unknown predictor strategy {name!r}; "
                     f"choose from {STRATEGIES}")
        if name == "rank-only" and policy == "trail":
            # the ordinal strategy needs the rank-aware scheduler path;
            # only the default policy is overridden — an explicit
            # incompatible choice still errors in the engine
            policy = "rank"

    if args.replicas > 1:
        if args.real:
            ap.error("cluster mode is sim-only (one device pool)")
        stats = run_cluster(
            cfg, reqs, router_policy=args.router,
            n_replicas=args.replicas, policy=policy,
            c_limit=c_limit, max_batch=args.max_batch,
            mem_budget=mem_budget, hardware=hardware, seed=args.seed,
            kv_layout=kv_layout, prefix_cache=args.prefix_cache,
            predictor=pred_spec,
            prefill_replicas=prefill_replicas,
            faults=faults, max_retries=args.max_retries,
            deadline_s=args.deadline, ttft_deadline_s=args.ttft_deadline,
            shed_watermark=args.shed_watermark,
            admission_control=args.admission_control,
            age_boost=age_boost, age_delay_s=age_delay,
            deadline_slack_s=deadline_slack,
            record_events=bool(args.metrics_out))
        print(json.dumps({"arch": cfg.name, "policy": policy,
                          "predictor": pred_spec or "trail-probe",
                          "router": args.router, "replicas": args.replicas,
                          **({"disagg": args.disagg} if args.disagg else {}),
                          "scenario": (f"trace:{args.trace}" if args.trace
                                       else args.scenario or "poisson"),
                          "rate": rate, **stats.summary()}, indent=1))
        if args.metrics_out:
            _write_metrics(args.metrics_out, stats.event_log, cfg,
                           hardware, reqs, kv_layout=kv_layout)
        return stats, stats.event_log

    model = None
    mode = "sim"
    predictor = None
    if args.real:
        from repro_torch.models.model import Model
        from repro_torch.serving.predictors import ProbePredictor
        model = Model(cfg, device=args.device).init(args.seed)
        predictor = ProbePredictor(cfg.probe, probe_params=model.probe,
                                   embed_table=model.embed)
        mode = "real"

    event_log = None
    if args.metrics_out:
        from repro_torch.metrics import EventLog
        event_log = EventLog()
    stats = run_policy(
        cfg, policy, reqs, c_limit=c_limit, max_batch=args.max_batch,
        mem_budget=mem_budget, mode=mode,
        predictor=predictor if predictor is not None else (pred_spec or None),
        model=model, device=args.device, hardware=hardware, seed=args.seed,
        kv_layout=kv_layout, prefix_cache=args.prefix_cache,
        deadline_s=args.deadline, ttft_deadline_s=args.ttft_deadline,
        shed_watermark=args.shed_watermark,
        admission_control=args.admission_control,
        age_boost=age_boost, age_delay_s=age_delay,
        deadline_slack_s=deadline_slack,
        event_log=event_log)
    print(json.dumps({"arch": cfg.name, "policy": policy,
                      "predictor": ("probe" if args.real
                                    else pred_spec or "trail-probe"),
                      "c": c_limit, "rate": rate,
                      "scenario": (f"trace:{args.trace}" if args.trace
                                   else args.scenario or
                                   ("burst" if args.burst else "poisson")),
                      **stats.summary()}, indent=1))
    if args.metrics_out:
        _write_metrics(args.metrics_out, event_log, cfg, hardware, reqs,
                       kv_layout=kv_layout)
    return stats, event_log


def _run_front_door(args, cfg, *, policy, pred_spec, c_limit, age_boost,
                    age_delay_s, deadline_slack_s):
    """Run the online front door / closed-loop client modes.

    Three shapes, all over one sim engine built from the shared CLI
    knobs: ``--serve`` alone binds the HTTP/SSE server and serves until
    interrupted; ``--serve --clients N`` additionally drives it with a
    live socket pool and prints the closed-loop summary; ``--clients N``
    alone runs the deterministic in-process closed loop on the engine's
    virtual clock. Returns (the pool's `PoolStats`, or None when serving
    until interrupted, and the engine's event log).
    """
    from repro_torch.clients import (ClientPoolConfig, run_closed_loop,
                                     run_live_pool)
    from repro_torch.metrics import EventLog
    from repro_torch.serving.engine import Engine, EngineConfig
    hardware = (HardwareSpec(name="compute-bound-2tf", peak_flops=2e12,
                             hbm_bw=819e9, overhead_s=2e-4)
                if args.compute_bound else HardwareSpec())
    mem_budget = int(args.mem_gb * 1e9) if args.mem_gb else 1 << 62
    kv_layout = args.kv_layout or ("paged" if args.prefix_cache or args.tail
                                   else "contig")
    engine = Engine(cfg, EngineConfig(
        policy=policy, c_limit=c_limit, max_batch=args.max_batch,
        mem_budget=mem_budget, kv_layout=kv_layout,
        prefix_cache=args.prefix_cache, predictor=pred_spec,
        hardware=hardware, seed=args.seed, deadline_s=args.deadline,
        ttft_deadline_s=args.ttft_deadline,
        shed_watermark=args.shed_watermark,
        admission_control=args.admission_control, age_boost=age_boost,
        age_delay_s=age_delay_s, deadline_slack_s=deadline_slack_s),
        event_log=EventLog())
    pool = ClientPoolConfig(
        n_clients=args.clients or 0,
        requests_per_client=args.requests_per_client or 4,
        think_time_s=(2.0 if args.think_time is None else args.think_time),
        timeout_s=args.deadline, max_retries=args.max_retries,
        seed=args.seed)
    meta = {"arch": cfg.name, "policy": policy,
            "predictor": pred_spec or "trail-probe"}
    if not args.serve:
        stats = run_closed_loop(engine, pool)
        print(json.dumps({**meta, "mode": "closed-loop",
                          "clients": pool.n_clients,
                          **stats.summary()}, indent=1))
        return stats, engine.events

    import asyncio

    from repro_torch.server import EngineServer, ServerConfig
    scfg = ServerConfig(port=8100 if args.port is None else args.port,
                        time_scale=args.time_scale or 1.0,
                        vocab=cfg.vocab_size, seed=args.seed)

    async def _amain():
        server = EngineServer(engine, scfg)
        await server.start()
        if args.clients:
            try:
                return await run_live_pool(scfg.host, server.port, pool,
                                           time_scale=scfg.time_scale)
            finally:
                await server.close()
        print(json.dumps({**meta, "mode": "serve",
                          "url": f"http://{scfg.host}:{server.port}",
                          "time_scale": scfg.time_scale}), flush=True)
        await server.serve_forever()

    try:
        stats = asyncio.run(_amain())
    except KeyboardInterrupt:
        return None, engine.events
    if stats is not None:
        print(json.dumps({**meta, "mode": "live",
                          "clients": pool.n_clients,
                          "time_scale": scfg.time_scale,
                          **stats.summary()}, indent=1))
    return stats, engine.events


def _write_metrics(path: str, event_log, cfg, hardware, reqs,
                   kv_layout: str = "contig"):
    """Roll the captured event stream up and write/print the report.

    The slowdown denominator must come from the same cost regime that
    drove the engine's clock, so a paged engine gets a paged CostModel
    (page-granular cache streaming) — otherwise slowdowns would divide
    paged-clock completions by contiguous-clock ideals.
    """
    from repro_torch.metrics import (ideal_service_times, report_json,
                                     report_markdown, rollup)
    from repro_torch.serving.costmodel import CostModel
    from repro_torch.serving.engine import EngineConfig
    page = EngineConfig().page_size if kv_layout == "paged" else 0
    service = ideal_service_times(CostModel(cfg, hardware, page_size=page),
                                  reqs)
    # per-tenant TTFT/completion splits whenever the workload is tagged
    # (multi-tenant scenarios, tenant-annotated traces)
    tenants = {r.rid: r.tenant for r in reqs if r.tenant}
    report = rollup(event_log, service_times=service,
                    tenants=tenants or None)
    with open(path, "w") as f:
        f.write(report_json(report))
    print(report_markdown(report, title=f"metrics -> {path}"))


if __name__ == "__main__":
    main()
