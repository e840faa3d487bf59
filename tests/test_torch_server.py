"""The port's front door (``server``) and client pools (``clients``).

The in-process closed loop gives the reference's ``PoolStats.summary()``
and per-record times for the same seed, with sessions, retries and an
admission watermark; the committed cells ``BENCH_serve_live.json``
``clients=8.trail`` and ``clients=8.fcfs`` are rebuilt exactly from port
modules alone, following ``benchmarks/serve_live.py``. The HTTP/SSE layer
frames and parses as the reference's. Against a live ``EngineServer`` on
localhost: health, 404 and bad JSON, a token stream to its finish, a
deadline as a timeout event, 429 with ``Retry-After`` over the admission
watermark, a dropped client cancelled inside the engine, and socket
clients driving the door to the end. Every live test bounds its own time
with ``asyncio.wait_for``.
"""

import asyncio
import json
from collections import defaultdict
from pathlib import Path

import pytest

from repro import clients as jax_clients
from repro.config import get_config
from repro.metrics import EventLog as JaxEventLog
from repro.server import http as jax_http
from repro.serving import engine as jax_engine
from repro_torch import clients
from repro_torch.config import get_config as port_config
from repro_torch.metrics import EventLog, check_invariants
from repro_torch.server import EngineServer, ServerConfig
from repro_torch.server import http
from repro_torch.serving import engine as port_engine
from repro_torch.serving.costmodel import HardwareSpec
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.request import Request

ROOT = Path(__file__).resolve().parents[1]
CFG = port_config("granite-3-8b")
LIVE_LIMIT_S = 60.0          # no live test may take longer than this


def _engine(**kw):
    return Engine(CFG, EngineConfig(policy="trail", hardware=HardwareSpec(),
                                    seed=0, **kw), event_log=EventLog())


# ---------------------------------------------------------------------------
# the closed loop against the reference
# ---------------------------------------------------------------------------

def closed_loop(who, pool_kw, **engine_kw):
    """One in-process pool run: (summary, records, engine summary)."""
    if who == "ref":
        eng_mod, pkg, log_cls, cfg = (jax_engine, jax_clients, JaxEventLog,
                                      get_config("granite-3-8b"))
    else:
        eng_mod, pkg, log_cls, cfg = port_engine, clients, EventLog, CFG
    eng = eng_mod.Engine(cfg, eng_mod.EngineConfig(
        hardware=HardwareSpec(), seed=0, **engine_kw), event_log=log_cls())
    stats = pkg.run_closed_loop(eng, pkg.ClientPoolConfig(**pool_kw))
    records = [(r.client, r.turn, r.rid, r.t_first_issue, r.t_issue,
                r.t_first_token, r.t_done, r.tokens, r.retries, r.outcome,
                r.fail_kind) for r in stats.records]
    return stats.summary(), records, eng.stats.summary()


@pytest.mark.parametrize("pool_kw,engine_kw", [
    (dict(n_clients=6, requests_per_client=3, think_time_s=1.0, seed=42),
     dict(policy="trail")),
    (dict(n_clients=4, requests_per_client=6, think_time_s=0.05,
          session_len=2, session_gap_s=60.0, seed=7), dict(policy="fcfs")),
    (dict(n_clients=6, requests_per_client=2, think_time_s=0.0,
          max_retries=1, retry_backoff_s=0.5, seed=3),
     dict(policy="trail", shed_watermark=600.0, admission_control=True)),
    (dict(n_clients=12, requests_per_client=3, think_time_s=1.0,
          timeout_s=4.0, max_retries=2, prefix_len=64, seed=5),
     dict(policy="trail", kv_layout="paged", prefix_cache=True)),
], ids=["trail", "sessions-fcfs", "shed-retries", "timeouts-prefix"])
def test_closed_loop_equals_the_reference(pool_kw, engine_kw):
    ref = closed_loop("ref", pool_kw, **engine_kw)
    got = closed_loop("port", pool_kw, **engine_kw)
    assert got == ref
    summary = got[0]
    assert summary["issued"] == (pool_kw["n_clients"]
                                 * pool_kw["requests_per_client"])
    assert summary["finished"] + summary["lost"] == summary["issued"]


@pytest.mark.parametrize("policy", ["trail", "fcfs"])
def test_committed_serve_live_cell_rebuilt_exactly(policy):
    """``BENCH_serve_live.json`` ``clients=8.<policy>``: 8 users, 4
    requests each, think time 2 s, one engine under the TPU v5e point."""
    log = EventLog()
    eng = Engine(CFG, EngineConfig(policy=policy, hardware=HardwareSpec(),
                                   seed=0, shed_watermark=0.0,
                                   admission_control=False), event_log=log)
    stats = clients.run_closed_loop(eng, clients.ClientPoolConfig(
        n_clients=8, requests_per_client=4, think_time_s=2.0, seed=0))
    check_invariants(log)
    got = stats.summary()
    got["shed_events"] = eng.stats.n_shed
    want = json.loads((ROOT / "BENCH_serve_live.json").read_text())[
        "grid"][f"clients=8.{policy}"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_closed_loop_think_time_semantics():
    for think in (0.0, 5.0):
        stats = clients.run_closed_loop(_engine(), clients.ClientPoolConfig(
            n_clients=3, requests_per_client=3, think_time_s=think, seed=1))
        turns = defaultdict(list)
        for r in stats.records:
            turns[r.client].append(r)
        for recs in turns.values():
            recs.sort(key=lambda r: r.turn)
            for prev, cur in zip(recs, recs[1:]):
                assert prev.outcome == "finish"
                if think == 0.0:
                    assert cur.t_first_issue == prev.t_done
                else:
                    assert cur.t_first_issue > prev.t_done


# ---------------------------------------------------------------------------
# Engine.on_token
# ---------------------------------------------------------------------------

def test_on_token_stream_matches_the_event_log():
    """Each rid sees first_token -> tokens* -> finish, exactly the event
    log's streamed slice; terminal events unsubscribe."""
    from repro_torch.serving.workload import WorkloadConfig, generate
    eng = _engine()
    reqs = generate(WorkloadConfig(n_requests=6, request_rate=30.0, seed=3,
                                   vocab=CFG.vocab_size))
    seen = {r.rid: [] for r in reqs}
    for r in reqs:
        eng.submit(r)
        eng.on_token(r.rid, lambda t, k, v, rid=r.rid:
                     seen[rid].append((t, k, v)))
    while eng.has_work():
        eng.step()
    per_req = eng.events.per_request()
    for r in reqs:
        kinds = [k for _, k, _ in seen[r.rid]]
        assert kinds[0] == "first_token" and kinds[-1] == "finish"
        assert set(kinds[1:-1]) == {"tokens"}
        assert sum(int(v) for _, k, v in seen[r.rid] if k == "tokens") \
            == len(r.generated)
        assert [(t, k) for t, k, _ in seen[r.rid]] == \
            [(e.t, e.kind) for e in per_req[r.rid]
             if e.kind in ("first_token", "tokens", "finish")]
    assert eng._subs == {}


def test_on_token_terminal_cancel_and_timeout():
    eng = _engine()
    events = []
    eng.submit(Request(0, 0.0, [1] * 16, true_out_len=400))
    eng.submit(Request(1, 500.0, [1] * 16, true_out_len=8))
    eng.on_token(0, lambda t, k, v: events.append((0, k)))
    eng.on_token(1, lambda t, k, v: events.append((1, k)))
    eng.step()
    assert eng.cancel(0, "timeout")
    assert eng.cancel(1, "shed")
    assert (0, "timeout") in events and (1, "shed") in events
    assert eng._subs == {}
    eng.off_token(0)


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

def _feed(data: bytes):
    reader = asyncio.StreamReader()
    reader.feed_data(data)
    reader.feed_eof()
    return reader


@pytest.mark.parametrize("data", [
    b"POST /v1/generate?x=1 HTTP/1.1\r\nHost: h\r\nContent-Length: 2"
    b"\r\n\r\n{}",
    b"GET /healthz HTTP/1.0\r\nX-A: b:c\r\n\r\n", b"", b"NOT-HTTP\r\n\r\n",
    b"GET / HTTP/1.1\r\nContent-Length: no\r\n\r\n",
    b"GET / HTTP/1.1\r\nno-colon\r\n\r\n", b"GET / HTTP/1.1\r\nHost",
    f"POST / HTTP/1.1\r\nContent-Length: {(1 << 20) + 1}\r\n\r\n".encode(),
], ids=["post", "get", "eof", "garbage", "bad-length", "bad-header",
        "truncated", "too-large"])
def test_http_parsing_equals_the_reference(data):
    def parse(mod):
        async def main():
            try:
                return await mod.read_request(_feed(data))
            except mod.HttpError as e:
                return ("HttpError", e.status, e.detail)
        return asyncio.run(main())
    assert parse(http) == parse(jax_http)


def test_http_framing_equals_the_reference():
    for status in (200, 400, 404, 429, 418):
        payload = {"b": [1, 2], "a": "x", "status": status}
        extra = {"Retry-After": "3"} if status == 429 else None
        assert http.response(status, payload, extra=extra) == \
            jax_http.response(status, payload, extra=extra)
    assert http.sse_preamble() == jax_http.sse_preamble()
    assert http.sse_event({"event": "tokens", "n": 4, "t": 0.5}) == \
        jax_http.sse_event({"event": "tokens", "n": 4, "t": 0.5})


# ---------------------------------------------------------------------------
# the live server (in-process asyncio, OS-assigned port)
# ---------------------------------------------------------------------------

async def _request(port, method, path, body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n"
                  f"Connection: close\r\n\r\n").encode() + body)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    status = int(lines[0].split(" ")[1])
    headers = {}
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if sep:
            headers[name.strip().lower()] = value.strip()
    payload = json.loads(await reader.read())
    writer.close()
    return status, payload, headers


async def _open_stream(port, payload):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode()
    writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    assert b"200" in head.split(b"\r\n")[0]
    return reader, writer


async def _generate_stream(port, payload):
    reader, writer = await _open_stream(port, payload)
    events = []
    while True:
        line = await reader.readline()
        if not line:
            break
        line = line.strip()
        if line.startswith(b"data: "):
            events.append(json.loads(line[6:]))
            if events[-1]["event"] in ("finish", "cancel", "timeout",
                                       "shed"):
                break
    writer.close()
    return events


def _serve(coro_fn, skw=None, **ekw):
    """Run one test body against a started server, then tear down; the
    whole of it within ``LIVE_LIMIT_S``."""
    async def main():
        eng = _engine(**ekw)
        server = EngineServer(eng, ServerConfig(
            **{"port": 0, "time_scale": 200.0, **(skw or {})}))
        await server.start()
        try:
            return await coro_fn(server, eng)
        finally:
            await server.close()

    return asyncio.run(asyncio.wait_for(main(), LIVE_LIMIT_S))


def test_server_healthz_404_bad_json_and_stream_to_finish():
    async def body(server, eng):
        status, payload, _ = await _request(server.port, "GET", "/healthz")
        assert status == 200 and payload["accepted"] == 0
        assert (await _request(server.port, "GET", "/nope"))[0] == 404
        status, payload, _ = await _request(server.port, "POST",
                                            "/v1/generate", b"{not json")
        assert status == 400 and "error" in payload
        status, _, _ = await _request(
            server.port, "POST", "/v1/generate",
            json.dumps({"prompt": [1, 2], "prompt_tokens": 4}).encode())
        assert status == 400
        events = await _generate_stream(
            server.port, {"prompt_tokens": 16, "out_tokens": 6})
        kinds = [e["event"] for e in events]
        assert kinds[:2] == ["accepted", "first_token"]
        assert kinds[-1] == "finish"
        assert sum(e.get("n", 0) for e in events
                   if e["event"] == "tokens") == 6
        status, payload, _ = await _request(server.port, "GET", "/metrics")
        assert status == 200 and payload["requests"]["finished"] == 1

    _serve(body)


def test_server_deadline_maps_to_timeout_event():
    async def body(server, eng):
        events = await _generate_stream(
            server.port,
            {"prompt_tokens": 16, "out_tokens": 500, "timeout_s": 2.0})
        assert events[-1]["event"] == "timeout"
        assert eng.stats.n_timeouts == 1

    _serve(body)


def test_server_backpressure_429_with_retry_after():
    async def body(server, eng):
        reader, writer = await _open_stream(
            server.port, {"prompt_tokens": 64, "out_tokens": 500})
        await reader.readline()                 # the accepted event
        status, payload, headers = await _request(
            server.port, "POST", "/v1/generate",
            json.dumps({"prompt_tokens": 8}).encode())
        assert status == 429 and int(headers["retry-after"]) >= 1
        assert payload["error"] == "overloaded"
        assert server.n_rejected == 1
        writer.close()

    _serve(body, skw={"admit_watermark": 250.0, "time_scale": 20.0})


def test_server_client_disconnect_cancels_request():
    async def body(server, eng):
        reader, writer = await _open_stream(
            server.port, {"prompt_tokens": 16, "out_tokens": 500})
        await reader.readline()
        writer.close()                          # the user walks away
        for _ in range(200):
            if eng.stats.n_cancelled:
                break
            await asyncio.sleep(0.02)
        assert eng.stats.n_cancelled == 1
        assert not eng.has_work()

    _serve(body)


def test_live_socket_pool_runs_to_the_end():
    """8 socket users against the door on localhost: every logical
    request finishes, the engine drains, its events pass the checks."""
    async def body(server, eng):
        return eng, await clients.run_live_pool(
            "127.0.0.1", server.port, clients.ClientPoolConfig(
                n_clients=8, requests_per_client=2, think_time_s=1.0,
                seed=0), time_scale=50.0)

    eng, stats = _serve(body, skw={"time_scale": 50.0})
    summary = stats.summary()
    assert summary["issued"] == 16 and summary["finished"] == 16
    assert summary["lost"] == 0
    assert not eng.has_work()
    check_invariants(eng.events)
