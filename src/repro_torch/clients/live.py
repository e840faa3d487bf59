"""Live-socket closed-loop clients for the HTTP/SSE front door.

The wall-clock twin of `repro_torch.clients.pool.run_closed_loop`: the
same `ClientPoolConfig`, the same per-client seeded draw streams, but each
user is an asyncio coroutine speaking real HTTP to a running
`repro_torch.server.EngineServer`. Think times, timeouts and backoffs are
divided by ``time_scale`` so a time-warped server is driven at the
matching wall rate, and recorded times are scaled back onto the virtual
clock so `PoolStats.summary` reads in the same units as the in-process
runner. A 429 answer counts as a ``shed`` failure and is retried after
the server's ``Retry-After`` (still charged against the retry budget);
a client-side timeout drops the connection, which the server turns into
``Engine.cancel()``.
"""

from __future__ import annotations

import asyncio
import json

from repro_torch.clients.pool import (
    ClientPoolConfig,
    ClientRecord,
    PoolStats,
    backoff_s,
    client_rngs,
    pool_workload,
    shared_prefix,
    think_draw,
)
from repro_torch.serving.workload import (sample_output_length,
                                          sample_prompt_length)

TERMINAL_EVENTS = ("finish", "cancel", "timeout", "shed")


async def _read_headers(reader) -> tuple[int, dict]:
    """Read a response's status line and headers (lower-cased names)."""
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ")[1])
    headers: dict[str, str] = {}
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if sep:
            headers[name.strip().lower()] = value.strip()
    return status, headers


async def _attempt(host: str, port: int, payload: dict, rec: ClientRecord,
                   clock) -> tuple[str, float]:
    """Run one generate attempt; returns (terminal kind, retry_after_s).

    ``clock()`` maps wall time onto the recording clock. Streams SSE
    events into ``rec`` until the terminal event; a 429 returns
    ``("shed", retry_after_s)`` without touching the record times.
    """
    body = json.dumps(payload).encode()
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: {host}\r\n"
                      f"Content-Type: application/json\r\n"
                      f"Content-Length: {len(body)}\r\n"
                      f"Connection: close\r\n\r\n").encode() + body)
        await writer.drain()
        status, headers = await _read_headers(reader)
        if status == 429:
            return "shed", float(headers.get("retry-after", "1"))
        if status != 200:
            return "cancel", 0.0
        while True:
            line = await reader.readline()
            if not line:
                return "cancel", 0.0          # server went away mid-stream
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            event = json.loads(line[len(b"data: "):])
            kind = event.get("event", "")
            if kind == "first_token":
                rec.t_first_token = clock()
            elif kind == "tokens":
                rec.tokens += int(event.get("n", 0))
            if kind in TERMINAL_EVENTS:
                return kind, 0.0
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass


async def run_live_pool(host: str, port: int, cfg: ClientPoolConfig, *,
                        time_scale: float = 1.0) -> PoolStats:
    """Drive a live front door with ``cfg.n_clients`` socket users.

    Returns the same `PoolStats` shape as the in-process runner, with
    record times in virtual seconds (wall elapsed × ``time_scale``).
    Wall-clock scheduling makes this runner non-deterministic — it is
    the integration/smoke path, not the benchmark path.
    """
    stats = PoolStats()
    wc = pool_workload(cfg)
    prefix = shared_prefix(cfg)
    loop = asyncio.get_running_loop()
    t0 = loop.time()

    def clock() -> float:
        return (loop.time() - t0) * time_scale

    async def one_user(c: int) -> None:
        think_rng, len_rng, content_rng = client_rngs(cfg, c)
        for turn in range(cfg.requests_per_client):
            await asyncio.sleep(think_draw(cfg, think_rng, turn)
                                / time_scale)
            p_len = sample_prompt_length(len_rng, wc)
            out_len = sample_output_length(len_rng, wc)
            body = [content_rng.randrange(cfg.vocab) for _ in range(p_len)]
            payload = {"prompt": prefix + body, "out_tokens": out_len,
                       "max_tokens": cfg.max_new_tokens,
                       "timeout_s": cfg.timeout_s, "tenant": f"c{c}"}
            rec = ClientRecord(client=c, turn=turn, rid=-1,
                               t_first_issue=clock())
            stats.records.append(rec)
            await _one_request(c, payload, rec)

    async def _one_request(c: int, payload: dict, rec: ClientRecord):
        attempt = 0
        while True:
            rec.t_issue, rec.t_first_token, rec.tokens = clock(), -1.0, 0
            try:
                coro = _attempt(host, port, payload, rec, clock)
                if cfg.timeout_s > 0:
                    kind, retry_after = await asyncio.wait_for(
                        coro, cfg.timeout_s / time_scale)
                else:
                    kind, retry_after = await coro
            except asyncio.TimeoutError:
                kind, retry_after = "timeout", 0.0
            except OSError:
                kind, retry_after = "cancel", 0.0
            if kind == "finish":
                rec.outcome, rec.t_done = "finish", clock()
                return
            stats.failures[kind] = stats.failures.get(kind, 0) + 1
            rec.fail_kind = kind
            if attempt >= cfg.max_retries:
                rec.outcome, rec.t_done = "lost", clock()
                return
            attempt += 1
            rec.retries = attempt
            wait = max(backoff_s(cfg, attempt), retry_after)
            await asyncio.sleep(wait / time_scale)

    await asyncio.gather(*(one_user(c) for c in range(cfg.n_clients)))
    stats.makespan = clock()
    return stats
