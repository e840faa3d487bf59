"""The port's ``traces`` package against the reference's: loaders on JSONL
and CSV files, the bundled fixture, synthesis, replay into requests, and
``serving.workload`` generating from a trace. Every output must equal the
reference's field for field (pure Python and numpy on both sides, so
exactly)."""

import dataclasses
import filecmp
import os

import pytest

from repro import traces as jtraces
from repro.serving import workload as jworkload
from repro_torch import traces as ttraces
from repro_torch.serving import workload as tworkload


def records(trace):
    return [dataclasses.astuple(r) for r in trace.records]


def same_trace(a, b):
    assert records(a) == records(b)
    assert a.mean_rate == b.mean_rate
    assert a.stats() == b.stats()


def same_requests(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.rid, x.arrival, x.prompt, x.true_out_len,
                x.max_new_tokens, x.tenant) == (
            y.rid, y.arrival, y.prompt, y.true_out_len, y.max_new_tokens,
            y.tenant)


JSONL = ('{"ts": 5.0, "context_tokens": 10, "generated_tokens": 4}\n'
         '\n'
         '{"TIMESTAMP": 2.5, "ContextTokens": 7, "GeneratedTokens": 3,'
         ' "tenant": "chat"}\n'
         '{"arrival": 9.25, "prompt_tokens": 300, "output_tokens": 0,'
         ' "app": "rag"}\n')
CSV = ("TIMESTAMP,ContextTokens,GeneratedTokens,tenant\n"
       "2023-11-16T18:00:01,100,20,chat\n"
       "2023-11-16T18:00:00,50,0,\n"
       "2023-11-16T18:00:03.500000,4000,7,rag\n")


@pytest.mark.parametrize("fmt", ["jsonl", "csv"])
def test_loaders_match_the_reference(tmp_path, fmt):
    path = tmp_path / f"t.{fmt}"
    path.write_text(JSONL if fmt == "jsonl" else CSV)
    load = {"jsonl": "load_jsonl", "csv": "load_csv"}[fmt]
    same_trace(getattr(jtraces, load)(str(path)),
               getattr(ttraces, load)(str(path)))
    same_trace(jtraces.load_trace(str(path), limit=2),
               ttraces.load_trace(str(path), limit=2))


def test_save_jsonl_writes_the_same_bytes(tmp_path):
    trace = jtraces.sample_trace()
    jtraces.save_jsonl(trace, str(tmp_path / "j.jsonl"))
    ttraces.save_jsonl(ttraces.sample_trace(), str(tmp_path / "t.jsonl"))
    assert filecmp.cmp(tmp_path / "j.jsonl", tmp_path / "t.jsonl",
                       shallow=False)


def test_the_port_ships_its_own_copy_of_the_fixture():
    path = ttraces.sample_trace_path()
    assert os.sep + "repro_torch" + os.sep in path
    assert filecmp.cmp(path, jtraces.sample_trace_path(), shallow=False)
    same_trace(jtraces.load_trace("sample"), ttraces.load_trace("sample"))


def test_synthesis_matches_the_reference():
    same_trace(jtraces.sample_trace(), ttraces.sample_trace())
    for method in ("copula", "rank-shuffle"):
        kw = dict(n_requests=200, mean_rate=3.0, seed=5, method=method)
        jt = [jtraces.TenantTraceSpec("a", weight=2.0, rho=0.6),
              jtraces.TenantTraceSpec("b", prompt_median=900.0,
                                      out_median=40.0, rho=-0.4)]
        tt = [ttraces.TenantTraceSpec(**dataclasses.asdict(s)) for s in jt]
        same_trace(
            jtraces.synthesize(jtraces.SynthesisConfig(tenants=tuple(jt),
                                                       **kw)),
            ttraces.synthesize(ttraces.SynthesisConfig(tenants=tuple(tt),
                                                       **kw)))


@pytest.mark.parametrize("knobs", [
    dict(rate_scale=24.0, seed=0, vocab=49155, limit=60),
    dict(rate_scale=2.0, time_warp=3.0, seed=7, vocab=1000, max_prompt=512,
         max_output=64),
])
def test_requests_from_trace_match_the_reference(knobs):
    same_requests(
        jtraces.requests_from_trace(jtraces.load_trace("sample"),
                                    jtraces.ReplayConfig(**knobs)),
        ttraces.requests_from_trace(ttraces.load_trace("sample"),
                                    ttraces.ReplayConfig(**knobs)))


@pytest.mark.parametrize("kw", [
    dict(n_requests=0, request_rate=0.0, seed=0, vocab=49155),
    dict(n_requests=60, request_rate=0.0, seed=1, vocab=49155,
         trace_rate_scale=24.0),
    dict(n_requests=40, request_rate=6.0, seed=2, vocab=1000),
])
def test_workload_generates_from_a_trace_as_the_reference(kw):
    """``--trace`` of the serve CLI: ``scenario_config("trace:...")`` then
    ``generate`` (the port raised here before ``traces`` was ported)."""
    same_requests(
        jworkload.generate(jworkload.scenario_config("trace:sample", **kw)),
        tworkload.generate(tworkload.scenario_config("trace:sample", **kw)))
