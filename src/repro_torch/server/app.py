"""The serving front door: admit continuously, stream tokens, shed load.

Request lifecycle (docs/ARCHITECTURE.md has the long-form version):

1. a socket delivers ``POST /v1/generate`` (JSON: token ids or lengths);
2. the door checks the predicted-work admission watermark — over it, the
   answer is ``429`` with a ``Retry-After`` derived from
   ``Engine.backlog_seconds()``;
3. otherwise the request is stamped with the current virtual time and
   handed to ``Engine.submit()``; a background task steps the engine
   whenever its clock lags wall time (scaled by ``time_scale``);
4. each megastep's per-request events flow through ``Engine.on_token``
   into the handler's ``asyncio.Queue`` and out as SSE ``data:`` chunks,
   ending with exactly one terminal event (``finish`` | ``timeout`` |
   ``shed`` | ``cancel``);
5. a client that disconnects mid-stream is cancelled inside the engine
   (``Engine.cancel(rid, "cancel")``), releasing its KV footprint.

``GET /healthz`` reports clock/backlog/queue depth; ``GET /metrics``
serves a live `repro_torch.metrics.rollup` of the attached event log.
"""

from __future__ import annotations

import asyncio
import json
import math
from contextlib import suppress
from dataclasses import dataclass
from random import Random

from repro_torch.metrics.rollup import rollup
from repro_torch.server import http
from repro_torch.serving.request import Request
from repro_torch.serving.workload import (
    WorkloadConfig,
    sample_output_length,
    sample_prompt_length,
)

TERMINAL_KINDS = ("finish", "cancel", "timeout", "shed")


@dataclass(frozen=True)
class ServerConfig:
    """Front-door knobs: transport and pacing, never scheduling.

    Engine-side behaviour (policy, watermarks for *shedding*, batch
    shape) stays in `EngineConfig`.

    Attributes:
        host: interface to bind.
        port: TCP port to bind (0 = let the OS pick; see
            ``EngineServer.port`` for the bound value).
        time_scale: virtual seconds the engine clock advances per wall
            second. 1.0 serves in real time; large values time-warp the
            sim clock so tests and smoke runs finish quickly.
        max_tokens_cap: upper bound accepted for ``max_tokens``.
        admit_watermark: predicted-token backlog (``Engine.backlog()``,
            pending included) above which the door answers 429 +
            Retry-After instead of admitting. 0 falls back to the
            engine's ``shed_watermark`` — note the engine also *sheds*
            over that mark, so a dedicated (usually higher) door value
            keeps 429s and sheds distinguishable.
        vocab: vocabulary for synthesizing prompt tokens from
            ``prompt_tokens`` counts.
        seed: seed for the server's prompt/output sampling streams.
    """

    host: str = "127.0.0.1"
    port: int = 8100
    time_scale: float = 1.0
    max_tokens_cap: int = 512
    admit_watermark: float = 0.0
    vocab: int = 32000
    seed: int = 0


def _parse_generate(body: bytes, scfg: ServerConfig) -> dict:
    """Validate a generate body into a plain dict of request fields.

    Accepts ``prompt`` (a token-id list) or ``prompt_tokens`` (a count
    the server synthesizes content for; both absent = server-sampled
    length), plus optional ``max_tokens`` / ``out_tokens`` /
    ``timeout_s`` / ``tenant``. Raises `HttpError` (400) on anything
    malformed, so invalid input never escapes as a traceback.
    """
    try:
        obj = json.loads(body.decode() or "{}")
    except (UnicodeDecodeError, json.JSONDecodeError):
        raise _bad("body is not valid JSON")
    if not isinstance(obj, dict):
        raise _bad("body must be a JSON object")
    prompt = obj.get("prompt")
    if prompt is not None and (not isinstance(prompt, list) or not prompt
                               or not all(isinstance(t, int)
                                          for t in prompt)):
        raise _bad("prompt must be a non-empty list of token ids")
    out: dict = {"prompt": prompt}
    for key, default, lo in (("prompt_tokens", 0, 1),
                             ("max_tokens", 512, 1), ("out_tokens", 0, 1)):
        value = obj.get(key, default)
        if not isinstance(value, int) or (value != default and value < lo):
            raise _bad(f"{key} must be an int >= {lo}")
        out[key] = min(value, scfg.max_tokens_cap) if value else value
    if prompt is not None and obj.get("prompt_tokens"):
        raise _bad("pass prompt or prompt_tokens, not both")
    timeout_s = obj.get("timeout_s", 0.0)
    if not isinstance(timeout_s, (int, float)) or timeout_s < 0:
        raise _bad("timeout_s must be a number >= 0")
    tenant = obj.get("tenant", "")
    if not isinstance(tenant, str):
        raise _bad("tenant must be a string")
    out.update(timeout_s=float(timeout_s), tenant=tenant)
    return out


def _bad(detail: str) -> http.HttpError:
    """Shorthand for the 400 validation error."""
    return http.HttpError(400, detail)


class EngineServer:
    """One engine behind one asyncio TCP listener.

    The caller constructs the engine (policy, watermark, deadlines,
    event log) and hands it over; the server owns the listener, the
    pacing task and the rid counter. Use ``await start()`` then either
    ``await serve_forever()`` (CLI) or keep the loop for tests and
    ``await close()`` when done.
    """

    def __init__(self, engine, scfg: ServerConfig | None = None):
        self.engine = engine
        self.scfg = scfg or ServerConfig()
        self.port = self.scfg.port          # rebound after start()
        self.n_accepted = 0
        self.n_rejected = 0
        self._rid = 0
        self._wake = asyncio.Event()
        self._server = None
        self._task = None
        self._t0 = 0.0
        self._loop = None
        self._wc = WorkloadConfig(
            n_requests=0, request_rate=1.0, vocab=self.scfg.vocab,
            seed=self.scfg.seed)
        self._len_rng = Random(f"{self.scfg.seed}:server:lens")
        self._content_rng = Random(f"{self.scfg.seed}:server:content")

    # -- lifecycle -----------------------------------------------------
    async def start(self):
        """Bind the listener and launch the engine pacing task."""
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle, self.scfg.host, self.scfg.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._t0 = self._loop.time()
        self._task = self._loop.create_task(self._drive())

    async def serve_forever(self):
        """Serve until cancelled (the ``--serve`` CLI path)."""
        async with self._server:
            await self._server.serve_forever()

    async def close(self):
        """Stop the pacing task and close the listener."""
        if self._task is not None:
            self._task.cancel()
            with suppress(asyncio.CancelledError):
                await self._task
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    def vnow(self) -> float:
        """Wall time since start, scaled onto the engine's clock."""
        return (self._loop.time() - self._t0) * self.scfg.time_scale

    async def _drive(self):
        """Step the engine whenever its clock lags (scaled) wall time.

        Idle engines park on an event set by each accepted request, so
        an empty server burns no CPU; a busy engine megasteps as fast as
        the pacing allows and yields between steps so handler coroutines
        can flush their queues onto the sockets.
        """
        eng = self.engine
        scale = self.scfg.time_scale
        while True:
            if not eng.has_work():
                self._wake.clear()
                await self._wake.wait()
                continue
            lag = eng.now - self.vnow()
            if lag > 0:
                await asyncio.sleep(min(lag / scale, 0.05))
                continue
            eng.step()
            await asyncio.sleep(0)

    # -- request handling ----------------------------------------------
    async def _handle(self, reader, writer):
        """Serve one connection: route, answer, close."""
        try:
            try:
                parsed = await http.read_request(reader)
            except http.HttpError as e:
                writer.write(http.response(e.status, {"error": e.detail}))
                await writer.drain()
                return
            if parsed is None:
                return
            method, path, _headers, body = parsed
            if method == "GET" and path == "/healthz":
                writer.write(http.response(200, self._health()))
                await writer.drain()
            elif method == "GET" and path == "/metrics":
                writer.write(http.response(200, self._metrics()))
                await writer.drain()
            elif method == "POST" and path == "/v1/generate":
                await self._generate(reader, writer, body)
            else:
                writer.write(http.response(
                    404, {"error": f"no route {method} {path}"}))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            with suppress(Exception):
                writer.close()
                await writer.wait_closed()

    def _health(self) -> dict:
        """Snapshot for ``GET /healthz``."""
        eng = self.engine
        return {
            "now": round(eng.now, 6), "vnow": round(self.vnow(), 6),
            "backlog_tokens": round(eng.backlog(), 3),
            "queue_len": eng.queue_len(),
            "accepted": self.n_accepted, "rejected_429": self.n_rejected,
        }

    def _metrics(self) -> dict:
        """Live rollup for ``GET /metrics`` (needs an attached log)."""
        if self.engine.events is None:
            return {"error": "engine has no event log attached"}
        return rollup(self.engine.events)

    def _retry_after(self) -> int:
        """Whole wall-seconds a 429'd client should wait before retry."""
        wall = self.engine.backlog_seconds() / self.scfg.time_scale
        return max(1, math.ceil(wall))

    def _materialize(self, spec: dict) -> tuple[list[int], int]:
        """Turn a validated generate spec into (prompt tokens, out len).

        Missing pieces are sampled from the server's seeded streams —
        prompt content for ``prompt_tokens`` requests, and the oracle
        output length (sim mode's synthetic EOS) when the client does
        not pin ``out_tokens``.
        """
        prompt = spec["prompt"]
        if prompt is None:
            n = spec["prompt_tokens"] or sample_prompt_length(
                self._len_rng, self._wc)
            prompt = [self._content_rng.randrange(self.scfg.vocab)
                      for _ in range(n)]
        out_len = spec["out_tokens"] or sample_output_length(
            self._len_rng, self._wc)
        return prompt, out_len

    async def _generate(self, reader, writer, body: bytes):
        """Admit one generate request and stream its events as SSE."""
        eng = self.engine
        try:
            spec = _parse_generate(body, self.scfg)
        except http.HttpError as e:
            writer.write(http.response(e.status, {"error": e.detail}))
            await writer.drain()
            return
        wm = self.scfg.admit_watermark or eng.ecfg.shed_watermark
        if wm > 0 and eng.backlog() > wm:
            retry = self._retry_after()
            self.n_rejected += 1
            writer.write(http.response(
                429, {"error": "overloaded", "retry_after_s": retry},
                extra={"Retry-After": str(retry)}))
            await writer.drain()
            return
        rid, self._rid = self._rid, self._rid + 1
        arrival = max(self.vnow(), eng.now)
        prompt, out_len = self._materialize(spec)
        req = Request(rid, arrival, prompt,
                      max_new_tokens=spec["max_tokens"],
                      true_out_len=out_len, tenant=spec["tenant"],
                      deadline_s=spec["timeout_s"])
        queue: asyncio.Queue = asyncio.Queue()
        eng.on_token(rid, lambda t, kind, v: queue.put_nowait((t, kind, v)))
        eng.submit(req)
        self.n_accepted += 1
        self._wake.set()
        writer.write(http.sse_preamble())
        writer.write(http.sse_event(
            {"event": "accepted", "rid": rid, "t": round(arrival, 6)}))
        await writer.drain()
        eof = self._loop.create_task(self._watch_eof(reader))
        try:
            await self._stream(writer, queue, eof, rid)
        except (ConnectionResetError, BrokenPipeError):
            eng.cancel(rid, "cancel")
        finally:
            eof.cancel()
            with suppress(asyncio.CancelledError):
                await eof
            eng.off_token(rid)

    async def _stream(self, writer, queue, eof, rid: int):
        """Relay queued events to the socket until a terminal kind.

        Watches the connection's read side concurrently: EOF before the
        terminal event means the client went away, which cancels the
        request inside the engine.
        """
        while True:
            get = self._loop.create_task(queue.get())
            done, _ = await asyncio.wait(
                {get, eof}, return_when=asyncio.FIRST_COMPLETED)
            if get not in done:
                get.cancel()
                with suppress(asyncio.CancelledError):
                    await get
                self.engine.cancel(rid, "cancel")
                return
            t, kind, value = get.result()
            payload = {"t": round(t, 6), "event": kind}
            if kind == "tokens":
                payload["n"] = int(value)
            writer.write(http.sse_event(payload))
            await writer.drain()
            if kind in TERMINAL_KINDS:
                return

    @staticmethod
    async def _watch_eof(reader):
        """Resolve once the peer half-closes (ignores stray bytes)."""
        while True:
            chunk = await reader.read(4096)
            if not chunk:
                return
