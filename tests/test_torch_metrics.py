"""The port's ``metrics`` package against the reference's: streaming
percentiles on the same samples, the event stream of one sim run (the
port's engine against the reference's), its invariants, and the rollup
with its JSON and markdown emitters, byte for byte. Pure Python and numpy
on both sides, so every comparison is exact."""

import numpy as np
import pytest

from repro import metrics as jmetrics
from repro.config import get_config
from repro.serving import costmodel as jcost
from repro.serving import engine as jengine
from repro.serving import workload as jworkload
from repro_torch import metrics as tmetrics
from repro_torch.config import get_config as port_config
from repro_torch.serving import costmodel as tcost
from repro_torch.serving import engine as tengine
from repro_torch.serving import workload as tworkload

HW = dict(name="compute-bound-2tf", peak_flops=2e12, hbm_bw=819e9,
          overhead_s=2e-4)


@pytest.mark.parametrize("n", [1, 2, 17, 999])
def test_streaming_quantiles_equal_the_reference(n):
    rng = np.random.default_rng(n)
    xs = rng.lognormal(1.0, 1.5, n).tolist()
    j, t = jmetrics.StreamingQuantiles(), tmetrics.StreamingQuantiles()
    for x in xs[: n // 2]:
        j.add(x)
        t.add(x)
    j.extend(xs[n // 2:])
    t.extend(xs[n // 2:])
    for q in (0.0, 10.0, 50.0, 90.0, 99.0, 99.9, 100.0):
        assert t.percentile(q) == j.percentile(q)
    assert t.summary() == j.summary()
    for slo in (0.5, 3.0, 30.0):
        assert t.attainment(slo) == j.attainment(slo)
    other = tmetrics.StreamingQuantiles(xs[:3])
    t.merge(other)
    j.merge(jmetrics.StreamingQuantiles(xs[:3]))
    assert t.summary() == j.summary()


def run(pkg, policy, kv_layout, **knobs):
    """One sim run with an event log: (log, requests, cost model)."""
    metrics, engine, workload, cost, get = pkg
    cfg = get("granite-3-8b")
    wc = workload.scenario_config("bursty", n_requests=48,
                                  request_rate=6.0, seed=3, vocab=1000)
    reqs = workload.generate(wc)
    log = metrics.EventLog()
    hw = cost.HardwareSpec(**HW)
    engine.run_policy(cfg, policy, reqs, hardware=hw, kv_layout=kv_layout,
                      mem_budget=int(4e9), event_log=log, seed=3, **knobs)
    page = engine.EngineConfig().page_size if kv_layout == "paged" else 0
    return log, reqs, cost.CostModel(cfg, hw, page_size=page)


REF = (jmetrics, jengine, jworkload, jcost, get_config)
PORT = (tmetrics, tengine, tworkload, tcost, port_config)


@pytest.mark.parametrize("policy,kv_layout,knobs", [
    ("trail", "contig", {}),
    ("fcfs", "paged", {}),
    ("trail", "paged", dict(deadline_s=20.0, shed_watermark=3000.0,
                            age_boost=256.0, age_delay_s=2.0)),
])
def test_event_stream_and_rollup_equal_the_reference(policy, kv_layout,
                                                     knobs):
    jlog, jreqs, jcm = run(REF, policy, kv_layout, **knobs)
    tlog, treqs, tcm = run(PORT, policy, kv_layout, **knobs)
    assert len(tlog) > 0 and tlog.as_dicts() == jlog.as_dicts()
    tmetrics.check_invariants(tlog)
    jservice = jmetrics.ideal_service_times(jcm, jreqs)
    tservice = tmetrics.ideal_service_times(tcm, treqs)
    assert tservice == jservice
    tenants = {r.rid: f"t{r.rid % 3}" for r in treqs}
    for kw in ({}, {"tenants": tenants}):
        want = jmetrics.rollup(jlog, service_times=jservice, **kw)
        got = tmetrics.rollup(tlog, service_times=tservice, **kw)
        assert tmetrics.report_json(got) == jmetrics.report_json(want)
        assert (tmetrics.report_markdown(got, title="m")
                == jmetrics.report_markdown(want, title="m"))
    # the port's rollup of the reference's own stream, rebuilt event by
    # event, gives the same bytes too
    rebuilt = tmetrics.EventLog()
    for e in jlog.events:
        rebuilt.emit(e.t, e.rid, e.kind, e.value)
    assert tmetrics.report_json(tmetrics.rollup(
        rebuilt, service_times=jservice)) == jmetrics.report_json(
            jmetrics.rollup(jlog, service_times=jservice))


def test_check_invariants_rejects_what_the_reference_rejects():
    for events in ([(0.0, 0, "arrival"), (1.0, 0, "finish")],
                   [(1.0, 0, "arrival"), (0.5, 0, "admit")],
                   [(0.0, 0, "arrival"), (2.0, 0, "admit"),
                    (1.0, 1, "arrival"), (1.5, 0, "cancel"),
                    (3.0, 0, "first_token")],
                   [(0.0, 0, "arrival"), (1.0, 0, "cancel"),
                    (2.0, 0, "first_token"), (2.0, 0, "tokens", 1.0),
                    (3.0, 0, "finish")]):
        logs = [jmetrics.EventLog(), tmetrics.EventLog()]
        for log in logs:
            for e in events:
                log.emit(*e)
        outcome = []
        for pkg, log in zip((jmetrics, tmetrics), logs):
            try:
                pkg.check_invariants(log)
                outcome.append(None)
            except AssertionError as err:
                outcome.append(str(err))
        assert outcome[0] is not None and outcome[1] == outcome[0]
