"""Minimal HTTP/1.1 + SSE wire helpers (stdlib-only, one request/conn).

Deliberately not a general web server: just enough protocol for the
front door. One request per connection (``Connection: close``), bounded
header and body sizes, JSON responses, and server-sent-event framing for
token streams. Anything malformed raises `HttpError`, which carries the
status code the handler should answer with — invalid input is a 4xx,
never a traceback on the wire.
"""

from __future__ import annotations

import asyncio
import json

MAX_BODY_BYTES = 1 << 20     # 1 MiB JSON bodies are already absurd here

_REASON = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
}


class HttpError(Exception):
    """Protocol or validation failure with the status code to send."""

    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


async def read_request(reader) -> tuple[str, str, dict, bytes] | None:
    """Parse one HTTP request; ``None`` on a clean EOF before any bytes.

    Returns ``(method, path, headers, body)`` with header names
    lower-cased and the path stripped of any query string. Raises
    `HttpError` on malformed framing or oversized payloads (the
    stream-reader limit bounds the header block).
    """
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise HttpError(400, "truncated request head") from None
    except asyncio.LimitOverrunError:
        raise HttpError(400, "request head too large") from None
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HttpError(400, f"bad request line {lines[0]!r}")
    method, target = parts[0].upper(), parts[1]
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise HttpError(400, f"bad header line {line!r}")
        headers[name.strip().lower()] = value.strip()
    length = headers.get("content-length", "0")
    if not length.isdigit():
        raise HttpError(400, f"bad Content-Length {length!r}")
    n = int(length)
    if n > MAX_BODY_BYTES:
        raise HttpError(413, f"body of {n} bytes exceeds {MAX_BODY_BYTES}")
    body = await reader.readexactly(n) if n else b""
    return method, target.split("?", 1)[0], headers, body


def response(status: int, payload: dict, *,
             extra: dict | None = None) -> bytes:
    """Build one complete JSON response (headers + body) as bytes."""
    body = json.dumps(payload, sort_keys=True).encode()
    lines = [f"HTTP/1.1 {status} {_REASON.get(status, 'Unknown')}",
             "Content-Type: application/json",
             f"Content-Length: {len(body)}",
             "Connection: close"]
    for name, value in (extra or {}).items():
        lines.append(f"{name}: {value}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def sse_preamble() -> bytes:
    """Start a streaming response: SSE headers, no Content-Length."""
    return (b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-store\r\n"
            b"Connection: close\r\n\r\n")


def sse_event(payload: dict) -> bytes:
    """Frame one SSE chunk: ``data: <json>`` plus the blank-line end."""
    return b"data: " + json.dumps(payload, sort_keys=True).encode() + b"\n\n"
